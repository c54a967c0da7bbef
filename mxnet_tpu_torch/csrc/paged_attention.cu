// Paged single-query decode attention for Hopper (sm_90a): split-K over
// fixed page chunks (flash-decoding), head-group page tiles staged by
// cp.async, and results that do not depend on the batch.
//
// Replaces the TPU kernels of the JAX package:
//   mxnet_tpu/decoding/attention.py:134  _paged_attn_kernel       (float pages)
//   mxnet_tpu/decoding/attention.py:177  _paged_attn_kernel_int8  (int8 pages)
// both launched by paged_attention_pallas (and, for the merged
// prefill+decode step, ragged_paged_attention_pallas).
//
// Contract (the same as the plain PyTorch version in
// mxnet_tpu_torch/decoding/attention.py):
//   q           (B, H, D)    float32, one query token per row
//   k/v pages   (N, P, H, D) float32, bfloat16 or int8
//   k/v scale   (N, P, H)    float32, int8 pages only
//   page_table  (B, Bp)      int32, seq-ordered page ids (padding -> page 0)
//   lengths     (B,)         int32, valid context tokens per row
//   out         (B, H, D)    float32
//   partial     (B, H, ceil(Bp / C), D + 2) float32 scratch (Bp > C only)
// out[b, h] = softmax(q[b, h] . K[b, :, h] / sqrt(D), masked to positions
// < lengths[b] with -1e30) . V[b, :, h]. A row of length 0 is masked
// everywhere, so -- exactly as in the JAX paths -- its softmax is uniform
// over all Bp * P positions of its table.
//
// Bound. A decode row has one query, so every score is a D-long dot
// product and the kernel is bound by bytes: it must read the pages the
// rows use once (K and V, plus the two scale planes for int8). At 3.35
// TB/s (H100 SXM) that byte count is its lower bound; the arithmetic (4 D
// flops a position and head) is far below the card's rate. Measured on
// an H100 (PERF.md), the split kernel takes float32 and bf16 pages at
// 3.3-3.5 TB/s of the pages the rows read (a page two rows share counted
// twice, so L2's hits count too); int8, whose arithmetic a byte
// (conversion, scales) is four times float32's, at about 2.5 TB/s.
//
// Design. The TPU kernel walks a sequential (B, Bp) grid, carrying the
// online-softmax state in VMEM across the page axis. Here the page axis
// is split into fixed chunks of C = kChunkPages consecutive table entries
// (8 pages, 128 tokens at P = 16), so a long row is read by many blocks
// at once:
//   1. The split kernel's grid is (row x head group, 1, chunk), head
//      groups fastest, so the blocks that read one page's slices start
//      together. A block takes G heads (one warp each; G = 4 at the
//      serving shape) of one chunk. A chunk that starts at or past the
//      row's last page (ceil(len / P), or Bp for a row of length 0) exits
//      at once and is never merged.
//   2. The block loads the chunk's page ids beside the row's length, then
//      stages each page's K and V slices of its G heads -- each slot's
//      G * D elements are contiguous in the pool -- with 16-byte
//      cp.async.cg copies into a ring of stages (3 for float32 and bf16,
//      4 for int8 at the serving shape), so the next pages' copies are in
//      flight while the current page is scored. One barrier a page hands
//      a stage over: at page i the block waits for page i's copies,
//      synchronizes (after which no warp still reads page i - 1's stage),
//      and issues page i + stages - 1 into that stage. Every slot's row of
//      a stage is padded by 16 bytes, so the quarter-warps' 16-byte reads
//      of eight slots fall in eight different bank groups. The SM's
//      shared memory is set all to shared (the copies bypass L1).
//   3. Warp w owns head h0 + w: lanes (s, half) = (lane % 16, lane / 16)
//      score slot s over half of D from their query registers, one
//      shuffle joins the halves, and shuffle butterflies give the page
//      max and sum (the same bits in every lane). For weights x V, lane t
//      takes dims 4(t % 16) .. + 3 of half the page's slots (t / 16), the
//      weights broadcast by shuffles; the two halves' sums are added once,
//      at the chunk's end. No block-wide barrier beyond the stage
//      hand-off. bf16 widens by a shift (a float's high half: the bits of
//      __bfloat162float); int8 is converted exactly by byte permutes (not
//      the conversion unit, which runs far below the FMA rate), and its
//      (slot, head) scales multiply the slot's dot product (K) and weight
//      (V) in registers: the pool is never upcast in memory.
//   4. The block writes its heads' online-softmax partial (m, l, acc[D])
//      to `partial`; the merge kernel combines each row's chunks in
//      ascending order over the row's own chunk count: M = max m_c, then
//      O = acc_0 w_0 (+ acc_c w_c ...), L = l_0 w_0 (+ l_c w_c ...) with
//      w_c = exp(m_c - M), and out = O / L. It is launched as a
//      programmatic dependent of the split kernel (its launch and length
//      loads overlap the split's end; griddepcontrol.wait precedes its
//      first read of a partial). Where Bp <= C there is one chunk and the
//      split kernel writes out = acc / l itself: the merge of a single
//      chunk is (acc * 1) / (l * 1), the same bits.
// Batch invariance. C, the lane arithmetic and the merge order depend on
// neither Bp nor the number of rows nor the other rows, and no sum uses
// atomics, so a row's result depends only on its own q, pages and length:
// the scheduler pads the table to a bucket chosen by the longest live
// row, and a stream served beside others equals the stream served alone.
// (The length-0 row is the exception by contract: it walks all Bp pages.)
// A page id past the row's last page is never read; padded entries point
// at page 0 and masking by length alone decides the weights.
//
// Instances. The serving page shape (P = 16, D = 64, H a multiple of 4)
// is a compile-time instance with 16-byte vector reads of shared memory.
// Other shapes (P <= 64, D <= 128, D * itemsize a multiple of 4 bytes)
// take a generic one: the same chunks, pipeline (2 stages) and merge,
// scalar reads, q in shared memory, copies of 16, 8 or 4 bytes, lane t
// scoring slots t and t + 32 and accumulating dims t + 32 i, and as many
// heads a block (4, 2 or 1) as fit shared memory; heads past H idle.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (mxnet_tpu_torch/kernels.py does this at first use).
// Each entry point returns the cudaGetLastError() of the first launch that
// failed (and which one in *failed: 1 the split kernel, 2 the merge), or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunkPages = 8;      // C: table entries of one split
constexpr int kMaxHeads = 4;        // heads (warps) a block
constexpr int kMaxHeadDim = 128;    // generic: dims t + 32 i, i < 4
constexpr int kMaxPageSize = 64;    // generic: slots t and t + 32
constexpr int kMaxChunks = 65535;   // gridDim.z
constexpr int kMaxSmemBytes = 232448;
constexpr int kRowPad = 16;         // bytes after each slot row of a stage
constexpr unsigned kFull = 0xffffffffu;

// the serving page shape
constexpr int kFastP = 16;
constexpr int kFastD = 64;

// stages of the serving instance (kMaxHeads heads a block), by page
// type: 100, 51 and 37 KB of shared memory, 2, 4 and 6 blocks an SM
template <typename T>
constexpr int fast_stages() {
  return sizeof(T) == 4 ? 3 : sizeof(T) == 2 ? 3 : 4;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared memory of a block, in bytes: the chunk's page ids, q (generic
// instance only), then the stages, each K rows, V rows (P rows of
// round16(G D itemsize) + 16 bytes) and for int8 the K and V scales.
struct Layout {
  int row_stride, kv_bytes, sc_bytes, stage_bytes, q_off, stages_off, total;
};

__host__ __device__ constexpr Layout layout(int G, int P, int D, int size,
                                            bool scaled, int stages,
                                            bool q_shared) {
  const int row_stride = round16(G * D * size) + kRowPad;
  const int kv_bytes = P * row_stride;
  const int sc_bytes = scaled ? round16(P * G * 4) : 0;
  const int stage_bytes = 2 * kv_bytes + 2 * sc_bytes;
  const int q_off = round16(kChunkPages * 4);
  const int stages_off = q_off + (q_shared ? round16(G * D * 4) : 0);
  return Layout{row_stride, kv_bytes,   sc_bytes,
                stage_bytes, q_off,     stages_off,
                stages_off + stages * stage_bytes};
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// 16 bytes of shared memory as 16 / sizeof(T) floats
__device__ __forceinline__ void load16(const unsigned char* p, float* f,
                                       float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
// a bf16 pair of a 32-bit word as floats: bf16 is a float's high half
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ void load16(const unsigned char* p, float* f,
                                       __nv_bfloat16) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = bf16x2_to_float2(w[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
// int8 x as float, exactly, without the conversion unit: byte x ^ 0x80 =
// x + 128 under exponent 2^23 is the float 2^23 + 128 + x
__device__ __forceinline__ float byte_to_float(uint32_t w, int i) {
  const uint32_t bits =
      __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440u | i);
  return __uint_as_float(bits) - 8388736.f;
}
__device__ __forceinline__ void load16(const unsigned char* p, float* f,
                                       int8_t) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = byte_to_float(w[i >> 2], i & 3);
}

// four consecutive elements of shared memory as floats
__device__ __forceinline__ void load4(const unsigned char* p, float* f,
                                      float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load4(const unsigned char* p, float* f,
                                      __nv_bfloat16) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = bf16x2_to_float2(r.x);
  const float2 b = bf16x2_to_float2(r.y);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}
__device__ __forceinline__ void load4(const unsigned char* p, float* f,
                                      int8_t) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = byte_to_float(w, i);
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes)
                 : "memory");
}

// a copy of `unit` (16, 8 or 4) bytes, uniform across the block
__device__ __forceinline__ void cp_async_unit(uint32_t dst, const void* src,
                                              int unit) {
  if (unit == 16)
    cp_async<16>(dst, src);
  else if (unit == 8)
    cp_async<8>(dst, src);
  else
    cp_async<4>(dst, src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------- split kernel
// kP/kD > 0: the serving instance (kP = 16, kD = 64, kHeads = 4); 0 takes
// P, D and the heads a block (blockDim.x / 32) from the launch.
template <typename T, bool kScaled, int kP, int kD, int kHeads, int kStages>
__global__ void __launch_bounds__(32 * (kHeads > 0 ? kHeads : kMaxHeads))
    paged_split_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ partial,
    float* __restrict__ out, int H, int D_arg, int P_arg, int Bp, int unit_arg,
    float sm_scale) {
  constexpr bool kFast = kP > 0;
  constexpr int kSize = sizeof(T);
  const int P = kFast ? kP : P_arg;
  const int D = kFast ? kD : D_arg;
  const int G = kFast ? kHeads : static_cast<int>(blockDim.x >> 5);
  const int unit = kFast ? 16 : unit_arg;
  const int n_threads = 32 * G;

  // x = (row, head group), head groups fastest: the blocks that read one
  // page's slices start together
  const int groups = (H + G - 1) / G;
  const int row = blockIdx.x / groups;
  const int h0 = (blockIdx.x - row * groups) * G;
  const int chunk = blockIdx.z;
  const int n_chunks = gridDim.z;
  const int first = chunk * kChunkPages;
  const int tid = threadIdx.x;
  // the chunk's table entries load beside the row's length (entries past
  // the row's pages are read, never used), so the first page copies wait
  // on one memory round trip, not two
  const int* row_table = page_table + static_cast<int64_t>(row) * Bp + first;
  const int my_page =
      tid < kChunkPages && first + tid < Bp ? row_table[tid] : 0;
  const int len = lengths[row];
  const int row_pages = len > 0 ? min((len + P - 1) / P, Bp) : Bp;
  if (first >= row_pages) return;  // past the row: never merged
  const int n = min(kChunkPages, row_pages - first);
  const int heads = min(G, H - h0);

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = h0 + warp;
  const bool active = warp < heads;

  const Layout lay = layout(G, P, D, kSize, kScaled, kStages, !kFast);
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl_s = reinterpret_cast<int*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + lay.q_off);
  unsigned char* stages = smem + lay.stages_off;

  if (tid < n) tbl_s[tid] = my_page;
  const int64_t q_row = (static_cast<int64_t>(row) * H + h0) * D;

  // the query: the fast instance keeps its lane's half of D in registers
  constexpr int kQRegs = kFast ? kD / 2 : 1;
  float qr[kQRegs];
  if constexpr (kFast) {
    if (active) {
      const float4* qv = reinterpret_cast<const float4*>(
          q + q_row + warp * kD + (lane >> 4) * (kD / 2));
#pragma unroll
      for (int j = 0; j < kQRegs / 4; ++j) {
        const float4 t = qv[j];
        qr[4 * j] = t.x;
        qr[4 * j + 1] = t.y;
        qr[4 * j + 2] = t.z;
        qr[4 * j + 3] = t.w;
      }
    }
  } else {
    for (int i = tid; i < heads * D; i += n_threads) q_s[i] = q[q_row + i];
  }
  __syncthreads();

  // cp.async of table entry i's K/V slices of this block's heads (and
  // their scales) into stage st
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v_pages);
  const int units = heads * D * kSize / unit;  // copies a slot row
  auto issue = [&](int i, int st) {
    const int64_t page = tbl_s[i];
    unsigned char* k_st = stages + st * lay.stage_bytes;
    unsigned char* v_st = k_st + lay.kv_bytes;
    const uint32_t kd = smem_u32(k_st);
    const uint32_t vd = smem_u32(v_st);
    const int64_t base = (page * P * H + h0) * D * kSize;
    const int64_t slot_bytes = static_cast<int64_t>(H) * D * kSize;
    if constexpr (kFast) {
      constexpr int kUnits = kHeads * kD * kSize / 16;
      constexpr int kPerThread = kP * kUnits / (32 * kHeads);
      static_assert(kPerThread * 32 * kHeads == kP * kUnits,
                    "a page's copies split evenly over the block");
#pragma unroll
      for (int it = 0; it < kPerThread; ++it) {
        const int e = tid + it * 32 * kHeads;
        const int s = e / kUnits;
        const int u = e - s * kUnits;
        const int64_t src = base + s * slot_bytes + u * 16;
        const uint32_t off = s * lay.row_stride + u * 16;
        cp_async<16>(kd + off, kb + src);
        cp_async<16>(vd + off, vb + src);
      }
    } else {
      for (int e = tid; e < P * units; e += n_threads) {
        const int s = e / units;
        const int u = e - s * units;
        const int64_t src = base + s * slot_bytes + u * unit;
        const uint32_t off = s * lay.row_stride + u * unit;
        cp_async_unit(kd + off, kb + src, unit);
        cp_async_unit(vd + off, vb + src, unit);
      }
    }
    if constexpr (kScaled) {
      const uint32_t ksd = smem_u32(v_st + lay.kv_bytes);
      const uint32_t vsd = ksd + lay.sc_bytes;
      const int64_t sbase = page * P * H + h0;
      if constexpr (kFast) {  // a slot's G scales in 16-byte copies
        constexpr int kSUnits = kHeads * 4 / 16;
        for (int e = tid; e < kP * kSUnits; e += 32 * kHeads) {
          const int s = e / kSUnits;
          const int u = e - s * kSUnits;
          cp_async<16>(ksd + e * 16, k_scale + sbase + s * H + u * 4);
          cp_async<16>(vsd + e * 16, v_scale + sbase + s * H + u * 4);
        }
      } else {
        for (int e = tid; e < P * heads; e += n_threads) {
          const int s = e / heads;
          const int j = e - s * heads;
          cp_async<4>(ksd + (s * G + j) * 4, k_scale + sbase + s * H + j);
          cp_async<4>(vsd + (s * G + j) * 4, v_scale + sbase + s * H + j);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i, i);
    cp_async_commit();
  }

  float m = kNegInf;  // running max
  float l = 0.f;      // running denominator
  // running numerator: the fast instance's lane t sums dims 4(t % 16) to
  // 4(t % 16) + 3 over half of each page's slots (the halves are added
  // once, at the chunk's end); the generic one's dims t + 32 i
  constexpr int kAcc = kFast ? 4 : kMaxHeadDim / 32;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    // page i's copies landed (this thread's), then every thread's are
    // visible and no warp still reads the stage page i - 1 used
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < n) issue(next, next % kStages);
    cp_async_commit();
    if (!active) continue;

    const unsigned char* k_st = stages + (i % kStages) * lay.stage_bytes;
    const unsigned char* v_st = k_st + lay.kv_bytes;
    const float* ks_st = reinterpret_cast<const float*>(v_st + lay.kv_bytes);
    const float* vs_st = ks_st + lay.sc_bytes / 4;
    const int pos0 = (first + i) * P;

    if constexpr (kFast) {
      // scores: lane (s, half) takes slot s over half of D
      const int s = lane & (kP - 1);
      const int half = lane >> 4;
      const unsigned char* kr =
          k_st + s * lay.row_stride + (warp * kD + half * (kD / 2)) * kSize;
      constexpr int kVec = 16 / kSize;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < (kD / 2) / kVec; ++c) {
        float f[kVec];
        load16(kr + c * 16, f, T());
#pragma unroll
        for (int x = 0; x < kVec; ++x) dot += qr[c * kVec + x] * f[x];
      }
      dot += __shfl_xor_sync(kFull, dot, 16);
      // int8: the (slot, head) scale is common to the slot's D products
      if constexpr (kScaled) dot *= ks_st[s * kHeads + warp];
      const float sc = (pos0 + s < len) ? dot * sm_scale : kNegInf;
      float mp = sc;
#pragma unroll
      for (int off = kP / 2; off > 0; off >>= 1)
        mp = fmaxf(mp, __shfl_xor_sync(kFull, mp, off));
      const float m_new = fmaxf(m, mp);
      const float corr = expf(m - m_new);
      const float e = expf(sc - m_new);
      float es = e;
#pragma unroll
      for (int off = kP / 2; off > 0; off >>= 1)
        es += __shfl_xor_sync(kFull, es, off);
      l = l * corr + es;
      // weights x V: lane t takes dims 4(t % 16) .. + 3 of slots
      // (t / 16) P/2 .. + P/2 - 1, whose weights lanes j and j + 16 hold
      const int j0 = (lane >> 4) * (kP / 2);
      const unsigned char* vr =
          v_st + (warp * kD + 4 * (lane & 15)) * kSize + j0 * lay.row_stride;
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < kP / 2; ++jj) {
        // int8: the weight carries the slot's V scale
        float ej = __shfl_sync(kFull, e, j0 + jj);
        if constexpr (kScaled) ej *= vs_st[(j0 + jj) * kHeads + warp];
        float v4[4];
        load4(vr + jj * lay.row_stride, v4, T());
#pragma unroll
        for (int x = 0; x < 4; ++x) pv[x] += ej * v4[x];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[x] = acc[x] * corr + pv[x];
      m = m_new;
    } else {
      // scores: lane t takes slots t and t + 32
      float sc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = lane + 32 * r;
        sc[r] = -INFINITY;
        if (s < P) {
          const T* kr = reinterpret_cast<const T*>(k_st + s * lay.row_stride) +
                        warp * D;
          const float ksc = kScaled ? ks_st[s * G + warp] : 1.f;
          float dot = 0.f;
          for (int x = 0; x < D; ++x) {
            const float kf =
                kScaled ? to_float(kr[x]) * ksc : to_float(kr[x]);
            dot += q_s[warp * D + x] * kf;
          }
          sc[r] = (pos0 + s < len) ? dot * sm_scale : kNegInf;
        }
      }
      float mp = fmaxf(sc[0], sc[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mp = fmaxf(mp, __shfl_xor_sync(kFull, mp, off));
      const float m_new = fmaxf(m, mp);
      const float corr = expf(m - m_new);
      float e[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        e[r] = lane + 32 * r < P ? expf(sc[r] - m_new) : 0.f;
      float es = e[0] + e[1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        es += __shfl_xor_sync(kFull, es, off);
      l = l * corr + es;
      float pv[kAcc];
#pragma unroll
      for (int x = 0; x < kAcc; ++x) pv[x] = 0.f;
      for (int j = 0; j < P; ++j) {
        const float ej = __shfl_sync(kFull, j < 32 ? e[0] : e[1], j & 31);
        const T* vr =
            reinterpret_cast<const T*>(v_st + j * lay.row_stride) + warp * D;
        const float vsc = kScaled ? vs_st[j * G + warp] : 1.f;
#pragma unroll
        for (int x = 0; x < kAcc; ++x) {
          const int d = lane + 32 * x;
          if (d < D) {
            const float vf =
                kScaled ? to_float(vr[d]) * vsc : to_float(vr[d]);
            pv[x] += ej * vf;
          }
        }
      }
#pragma unroll
      for (int x = 0; x < kAcc; ++x) acc[x] = acc[x] * corr + pv[x];
      m = m_new;
    }
  }
  // the merge may launch now; it waits for this grid before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (!active) return;
  if constexpr (kFast) {  // the two halves of the slots: lanes t, t + 16
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[x] += __shfl_xor_sync(kFull, acc[x], 16);
  }

  const int64_t o_row = (static_cast<int64_t>(row) * H + h) * D;
  if (n_chunks == 1) {  // the merge of one chunk: (acc * 1) / (l * 1)
    if constexpr (kFast) {
      if (lane < 16)
        *reinterpret_cast<float4*>(out + o_row + 4 * lane) =
            make_float4(acc[0] / l, acc[1] / l, acc[2] / l, acc[3] / l);
    } else {
#pragma unroll
      for (int x = 0; x < kAcc; ++x)
        if (lane + 32 * x < D) out[o_row + lane + 32 * x] = acc[x] / l;
    }
    return;
  }
  float* pp = partial +
      ((static_cast<int64_t>(row) * H + h) * n_chunks + chunk) * (D + 2);
  if (lane == 0) {
    pp[0] = m;
    pp[1] = l;
  }
  if constexpr (kFast) {
    // (D + 2) * 4 bytes a partial: pp + 2 is 8-byte aligned
    if (lane < 16) {
      float2* dst = reinterpret_cast<float2*>(pp + 2 + 4 * lane);
      dst[0] = make_float2(acc[0], acc[1]);
      dst[1] = make_float2(acc[2], acc[3]);
    }
  } else {
#pragma unroll
    for (int x = 0; x < kAcc; ++x)
      if (lane + 32 * x < D) pp[2 + lane + 32 * x] = acc[x];
  }
}

// ---------------------------------------------------------- merge kernel
// One warp a (row, head). Every load that can be issued before the row's
// chunk count is known is issued with the load of its length, within the
// grid's chunks (so memory-safe; a chunk past the row's count is loaded
// but never used): lane t's (m, l) of chunk t < 32, and dims t + 32 i of
// the first kWindow chunks' acc. Then the row's max M over its chunks,
// w_c = exp(m_c - M), and the ascending sums L = l_0 w_0 + l_1 w_1 + ...
// and O[d] = acc_0[d] w_0 + ..., the same in every lane (w_c and l_c by
// shuffle); chunks from kWindow on (Bp > 128 pages) load as they come.
constexpr int kWindow = 16;

__global__ void __launch_bounds__(32 * kMaxHeads) paged_merge_kernel(
    const float* __restrict__ partial, const int* __restrict__ lengths,
    float* __restrict__ out, int H, int D, int P, int Bp, int n_chunks) {
  const int row = blockIdx.x;
  const int h = blockIdx.y * kMaxHeads + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= H) return;
  constexpr int kAcc = kMaxHeadDim / 32;
  const int stride = D + 2;
  const float* pp =
      partial + (static_cast<int64_t>(row) * H + h) * n_chunks * stride;
  const int len = lengths[row];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float m_t = -INFINITY, l_t = 0.f;
  if (lane < n_chunks) {
    m_t = pp[lane * stride];
    l_t = pp[lane * stride + 1];
  }
  float a[kWindow][kAcc];
#pragma unroll
  for (int j = 0; j < kWindow; ++j)
#pragma unroll
    for (int x = 0; x < kAcc; ++x)
      a[j][x] = j < n_chunks && lane + 32 * x < D
                    ? pp[j * stride + 2 + lane + 32 * x]
                    : 0.f;

  const int row_pages = len > 0 ? min((len + P - 1) / P, Bp) : Bp;
  const int nc = (row_pages + kChunkPages - 1) / kChunkPages;
  float M = lane < nc ? m_t : -INFINITY;
  for (int c = lane + 32; c < nc; c += 32) M = fmaxf(M, pp[c * stride]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
  const float w_t = lane < nc ? expf(m_t - M) : 0.f;

  // the first term is a product, not a sum: one chunk gives acc / l
  float L = 0.f;
  float o[kAcc];
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    if (j < nc) {
      const float w = __shfl_sync(kFull, w_t, j);
      const float lc = __shfl_sync(kFull, l_t, j);
      L = j == 0 ? lc * w : L + lc * w;
#pragma unroll
      for (int x = 0; x < kAcc; ++x)
        o[x] = j == 0 ? a[j][x] * w : o[x] + a[j][x] * w;
    }
  }
  for (int j = kWindow; j < nc; ++j) {
    const float* pc = pp + j * stride;
    const float w = j < 32 ? __shfl_sync(kFull, w_t, j & 31)
                           : expf(pc[0] - M);
    const float lc = j < 32 ? __shfl_sync(kFull, l_t, j & 31) : pc[1];
    L += lc * w;
#pragma unroll
    for (int x = 0; x < kAcc; ++x)
      if (lane + 32 * x < D) o[x] += pc[2 + lane + 32 * x] * w;
  }
  const int64_t o_row = (static_cast<int64_t>(row) * H + h) * D;
#pragma unroll
  for (int x = 0; x < kAcc; ++x) {
    const int d = lane + 32 * x;
    if (d < D) out[o_row + d] = o[x] / L;
  }
}

// ------------------------------------------------------------------ host
// The instance a call takes, from shapes alone.
struct Instance {
  int fast, heads, stages, smem, unit;
};

template <typename T, bool kScaled>
bool instance_of(int H, int D, int P, Instance* in) {
  constexpr int kSize = sizeof(T);
  if (H < 1 || D < 1 || D > kMaxHeadDim || P < 1 || P > kMaxPageSize)
    return false;
  const int bytes = D * kSize;
  const int unit = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8
                                        : bytes % 4 == 0 ? 4
                                                         : 0;
  if (unit == 0) return false;
  if (P == kFastP && D == kFastD && H % kMaxHeads == 0) {
    constexpr int kHeads = kMaxHeads;
    constexpr int kStages = fast_stages<T>();
    constexpr int kSmem =
        layout(kHeads, kFastP, kFastD, kSize, kScaled, kStages, false).total;
    static_assert(kSmem <= kMaxSmemBytes, "stages exceed shared memory");
    *in = Instance{1, kHeads, kStages, kSmem, 16};
    return true;
  }
  for (int g = kMaxHeads; g >= 1; g >>= 1) {
    const int smem = layout(g, P, D, kSize, kScaled, 2, true).total;
    if (smem <= kMaxSmemBytes || g == 1) {
      *in = Instance{0, g, 2, smem, unit};
      return smem <= kMaxSmemBytes;
    }
  }
  return false;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename T, bool kScaled>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* page_table, const void* lengths,
           void* out, void* partial, int B, int H, int D, int P, int Bp,
           void* stream_arg, int* failed) {
  *failed = 0;
  Instance in;
  if (B < 1 || Bp < 1 || !instance_of<T, kScaled>(H, D, P, &in))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (Bp + kChunkPages - 1) / kChunkPages;
  const int64_t blocks =
      static_cast<int64_t>(B) * ((H + in.heads - 1) / in.heads);
  if (n_chunks > kMaxChunks || blocks > 2147483647 ||
      (n_chunks > 1 && partial == nullptr) || !aligned(q, 16) ||
      !aligned(out, 8) || !aligned(k, in.unit) || !aligned(v, in.unit) ||
      (kScaled && (!aligned(ks, in.fast ? 16 : 4) ||
                   !aligned(vs, in.fast ? 16 : 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = in.fast ? paged_split_kernel<T, kScaled, kFastP, kFastD,
                                             kMaxHeads, fast_stages<T>()>
                        : paged_split_kernel<T, kScaled, 0, 0, 0, 2>;
  // the SM's shared memory all to shared (not L1: the copies bypass it),
  // so as many blocks fit as their stages allow
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) {
    *failed = 1;
    return static_cast<int>(err);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_arg);
  const float sm_scale = 1.f / sqrtf(static_cast<float>(D));
  kernel<<<dim3(static_cast<unsigned>(blocks), 1, n_chunks), 32 * in.heads,
           in.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(partial),
      static_cast<float*>(out), H, D, P, Bp, in.unit, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    *failed = 1;
    return static_cast<int>(err);
  }
  if (n_chunks == 1) return 0;
  // programmatic dependent launch: the merge's launch and its length
  // loads overlap the split kernel's end; it waits for the split grid
  // (griddepcontrol.wait) before it reads a partial
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, (H + kMaxHeads - 1) / kMaxHeads);
  cfg.blockDim = dim3(32 * kMaxHeads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_merge_kernel,
                           static_cast<const float*>(partial),
                           static_cast<const int*>(lengths),
                           static_cast<float*>(out), H, D, P, Bp, n_chunks);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) {
    *failed = 2;
    return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// C, the table entries of one split: the wrapper sizes `partial` by it.
int paged_attention_chunk_pages() { return kChunkPages; }

// Float pages: kv_bf16 = 0 for float32 storage, 1 for bfloat16. `partial`
// is (B, H, ceil(Bp / C), D + 2) float32 when Bp > C, else unused.
int paged_attention_float(const void* q, const void* k_pages,
                          const void* v_pages, const void* page_table,
                          const void* lengths, void* out, void* partial,
                          int B, int H, int D, int P, int Bp, int kv_bf16,
                          void* stream, int* failed) {
  if (kv_bf16)
    return launch<__nv_bfloat16, false>(q, k_pages, v_pages, nullptr, nullptr,
                                        page_table, lengths, out, partial, B,
                                        H, D, P, Bp, stream, failed);
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr,
                              page_table, lengths, out, partial, B, H, D, P,
                              Bp, stream, failed);
}

// Int8 pages with their (N, P, H) float32 scale planes.
int paged_attention_int8(const void* q, const void* k_pages,
                         const void* k_scale, const void* v_pages,
                         const void* v_scale, const void* page_table,
                         const void* lengths, void* out, void* partial, int B,
                         int H, int D, int P, int Bp, void* stream,
                         int* failed) {
  return launch<int8_t, true>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, lengths, out, partial, B, H, D, P,
                              Bp, stream, failed);
}

// out = {serving instance (1) or generic (0), heads a block, stages,
// dynamic shared memory bytes, copy bytes} of the instance a call with
// pages of `kind` (0 float32, 1 bfloat16, 2 int8) takes; nonzero when
// the kernel does not take the shape.
int paged_attention_instance(int kind, int H, int D, int P, int* out) {
  Instance in;
  const bool ok = kind == 0   ? instance_of<float, false>(H, D, P, &in)
                  : kind == 1 ? instance_of<__nv_bfloat16, false>(H, D, P, &in)
                  : kind == 2 ? instance_of<int8_t, true>(H, D, P, &in)
                              : false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = in.fast;
  out[1] = in.heads;
  out[2] = in.stages;
  out[3] = in.smem;
  out[4] = in.unit;
  return 0;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
