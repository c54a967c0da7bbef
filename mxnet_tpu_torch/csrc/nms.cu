// Greedy non-maximum suppression for Hopper (sm_90a): each segment's
// candidates in tiles, each tile tested against the segment's kept set.
//
// Replaces the device loop of the JAX package's NMS:
//   mxnet_tpu/ops/vision.py:416  _nms_loop  (a lax.fori_loop over a dense
//                                           K x K IoU)
// which MultiBoxDetection (per class, or every class with force_suppress)
// and Proposal (one class) call. It is not a Pallas kernel: the JAX
// package left the loop to XLA. Torch has no op that runs a sequential
// suppression on the device, so this is the port's kernel for it.
//
// Contract (the plain PyTorch version is nms_plain in
// mxnet_tpu_torch/ops/nms.py; nms_segmented_plain there is this file's
// algorithm in torch ops):
//   boxes    (G, K, 4) float32 corners [x1, y1, x2, y2], sorted by
//            descending score (a stable sort of the negated score)
//   classes  (G, K)    int64
//   nvalid   (G,)      int64: the candidates of image g with a score > 0
//   keep     (G, K)    uint8 out, every byte written
// keep[g, i] = 1 when i < nvalid[g] and no kept j < i of the same class
// (of any class with force_suppress) has IoU(box j, box i) > thresh.
//
// Only the valid prefix matters. A candidate with score 0 starts out not
// kept, so it is never kept and suppresses nothing; after the stable sort
// every score > 0 comes before every score 0 (and NaN), so the valid
// candidates are exactly the first nvalid[g] (tests/test_torch_vision.py
// holds nms_plain over the prefix to nms_plain over all K).
//
// IoU is computed as _iou_matrix (mxnet_tpu/ops/vision.py:253) computes
// it, in the same order: corner max/min, widths clamped at 0, inter,
// clamped areas, union = area_a + area_b - inter, then
// union > 0 ? inter / union : 0 with a true division, and the result is
// that quotient's bit against thresh. The library is compiled with
// -fmad=false (kernels.LIBRARIES), so no contraction moves a value.
// max/min propagate NaN as jnp.maximum / torch.maximum do. Where inter ==
// 0 the IoU is 0 exactly (0 / union with union > 0, or 0 where union <= 0
// or is NaN). Elsewhere the quotient is compared with thresh through two
// products that bound it (`decide`), which settles the bit exactly for
// all but the pairs within 2^-20 of thresh; those take the division. The
// earlier box of a pair (the kept one) is always `a`, as in the
// reference's row of the IoU matrix; the bit is the same with the two
// swapped (max, min, the products and the sum area_a + area_b are
// commutative in IEEE arithmetic), which chip_smoke.py's full-shape check
// relies on.
//
// Bound. Greedy NMS must test each valid candidate against every kept
// box of its segment that comes before it: 10 float operations a pair
// for the overlap alone (4 max/min, 2 subtractions, 2 clamps, 1 product,
// 1 test), over the card's 67 TFLOP/s of float32 outside the tensor
// cores; the inputs and keep bytes are a few MB. At SSD's detection (32 x
// 117,976 candidates, 20 classes) that is 5.26e8 pairs, 0.079 ms.
//
// Design. A segment is one (image, class) without force_suppress, one
// image with it; its members are the image's valid candidates of that
// class, in score order. Greedy NMS is independent for each segment, so
// one block of 256 threads, or a cluster of up to 8 blocks of 512 when
// the segments are few (Proposal's one), takes one segment. The blocks
// prefer all of shared memory to L1, so that several share an SM:
//   0. a prepare kernel (one launch for the call) writes every keep byte
//      to 0, and, when segments are classes, each valid candidate's class
//      slot (class - the smallest class, 16 bits) and each segment's
//      member count;
//   1. the block streams its image's class slots, 16 a thread, and
//      compacts its members, in order, into a tile of kTile (a block-wide
//      prefix count keeps the order);
//   2. cross test: every (kept box, tile member) pair in parallel, a
//      thread's kPerItem kept boxes against a word of 32 members read
//      from shared memory, skipping members already suppressed; a
//      member's bit set on any overlap. A cluster's blocks each hold
//      every csize-th kept box and OR their bits over distributed shared
//      memory;
//   3. the tile's survivors of (2) resolved among themselves: their S x S
//      overlap bits in shared memory, then one warp walks them in order;
//   4. the tile's kept members join the kept set (shared memory up to
//      `cap` boxes a block, then a global spill area read back through
//      L2), and their keep bytes are written.
// Only the pairs the bound counts are computed, plus each tile's
// survivors among themselves; there is no K x K mask. Segments with no
// member return at once, and the largest start first (cluster b takes
// the segment of rank b by member count). Without force_suppress and
// with class ids over
// a range of more than the wrapper's slot limit, a segment is an image
// and each pair also compares the two classes (kClassTest).
//
// Each entry point returns cudaGetLastError() after its launches (or the
// first error), never synchronizes, and allocates nothing.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kPerItem = 4;             // kept boxes a cross-test item
constexpr int kTile = 256;              // members a tile
constexpr int kWords = kTile / 32;      // 32-bit words of a tile's bit set
constexpr int kIdsPerThread = 16;       // class slots a thread streams
constexpr int kPrepThreads = 256;
constexpr int kPrepChunk = kPrepThreads * kIdsPerThread;
constexpr int kMaxSmem = 232448;        // 227 KB, the opt-in maximum
constexpr unsigned short kNoSlot = 0xFFFF;

// jnp.maximum / torch.maximum: NaN in either operand gives NaN (one
// instruction; which zero it returns for +0 and -0 never changes a
// result below: a zero there makes inter or union zero either way)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the intersection's area, in _iou_matrix's order of operations
__device__ __forceinline__ float intersection(float4 a, float4 b) {
  const float tlx = nan_max(a.x, b.x);
  const float tly = nan_max(a.y, b.y);
  const float brx = nan_min(a.z, b.z);
  const float bry = nan_min(a.w, b.w);
  const float w = nan_max(brx - tlx, 0.0f);
  const float h = nan_max(bry - tly, 0.0f);
  return w * h;
}

__device__ __forceinline__ float area(float4 a) {
  return nan_max((a.z - a.x) * (a.w - a.y), 0.0f);
}

// IoU(a, b) > thresh for a pair whose intersection is not 0 (or is NaN)
__device__ __forceinline__ bool overlaps_from(float4 a, float4 b,
                                              float inter, float thresh) {
  const float uni = area(a) + area(b) - inter;
  const float iou = uni > 0.0f ? inter / uni : 0.0f;
  return iou > thresh;
}

enum Verdict { kApart = 0, kOverlap = 1, kDivide = 2 };

// IoU(a, b) > thresh decided without the division where it can be:
// inter is the pair's intersection, area_a and area_b their areas. With
// `filter` (thresh in [2^-20, 2^20]) and a union in [2^-100, 2^100], the
// IoU's quotient x = inter / union satisfies, for P = fl(thresh * union),
//   inter <= fl(P * (1 - 2^-20))  =>  x < thresh (1 - 2^-20 + 2^-23)
//                                 =>  fl(x) <= thresh,
//   inter >= fl(P * (1 + 2^-20))  =>  x > thresh (1 + 2^-22)
//                                 =>  fl(x) > thresh,
// each product off by at most 2^-24 of itself and thresh's ulp at most
// 2^-23 of it. A pair between the two, or outside those ranges (NaN
// included), takes the division (kDivide). Every value is computed and
// the verdict selected, with no branch, so that a warp's lanes never
// part here.
__device__ __forceinline__ Verdict decide(float inter, float area_a,
                                          float area_b, float thresh,
                                          bool filter, bool zero_hit) {
  const float uni = area_a + area_b - inter;
  const float p = thresh * uni;
  const bool settled = filter && uni >= 0x1p-100f && uni <= 0x1p100f;
  const Verdict v = inter <= p * 0x1.fffffp-1f ? kApart      // 1 - 2^-20
      : (inter >= p * 0x1.00001p+0f ? kOverlap : kDivide);  // 1 + 2^-20
  return inter == 0.0f ? (zero_hit ? kOverlap : kApart)
                       : (settled ? v : kDivide);
}

// Shared memory of a segment block: the kept set (cap boxes, and their
// classes under kClassTest), then the tile.
struct Layout {
  int fixed, per_kept;
};

__host__ __device__ constexpr Layout layout(bool class_test) {
  return Layout{(kTile + kWords) * 20                // tile boxes, areas
                    + (class_test ? kTile * 8 : 0)           // their classes
                    + kTile * 4 * 2                          // tidx, surv
                    + kTile * kWords * 4                     // survivor mask
                    + kWords * 4 * 4          // sup (two), cluster's, kept
                    + 32 * 4 + 16,                           // scan, misc
                16 + (class_test ? 8 : 0)};
}

// Exclusive prefix sum of v over the block; *total gets the sum. Every
// thread of the block must call it. Ends with a barrier.
template <int kThreads>
__device__ __forceinline__ int block_scan(int v, int* warp_sums,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    __syncwarp();
    if (lane < kThreads / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[kThreads / 32 - 1];
  const int before = warp ? warp_sums[warp - 1] : 0;
  __syncthreads();  // warp_sums may be written again after this
  return before + x - v;
}

__global__ void __launch_bounds__(kPrepThreads)
nms_prepare_kernel(const long long* __restrict__ classes,
                   const long long* __restrict__ nvalid,
                   unsigned short* __restrict__ slots,
                   int* __restrict__ counts,
                   unsigned char* __restrict__ keep, int K, int Kp,
                   long long cls0, int nslots) {
  extern __shared__ int hist[];
  const int g = blockIdx.y;
  const int n = static_cast<int>(nvalid[g]);
  const int i0 = blockIdx.x * kPrepChunk;
  unsigned char* kp = keep + static_cast<size_t>(g) * K;
  for (int k = threadIdx.x; k < kPrepChunk; k += kPrepThreads)
    if (i0 + k < K) kp[i0 + k] = 0;
  if (slots == nullptr) return;
  for (int s = threadIdx.x; s < nslots; s += kPrepThreads) hist[s] = 0;
  __syncthreads();
  const long long* cl = classes + static_cast<size_t>(g) * K;
  unsigned short* sl = slots + static_cast<size_t>(g) * Kp;
  for (int k = threadIdx.x; k < kPrepChunk; k += kPrepThreads) {
    const int i = i0 + k;
    if (i >= Kp) break;
    unsigned short s = kNoSlot;
    if (i < n) {
      s = static_cast<unsigned short>(cl[i] - cls0);
      atomicAdd(&hist[s], 1);
    }
    sl[i] = s;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < nslots; s += kPrepThreads)
    if (hist[s]) atomicAdd(&counts[static_cast<size_t>(g) * nslots + s],
                           hist[s]);
}

template <int kThreads, bool kClassTest>
__global__ void __launch_bounds__(kThreads)
nms_segment_kernel(const float4* __restrict__ boxes,
                   const long long* __restrict__ classes,
                   const long long* __restrict__ nvalid,
                   const unsigned short* __restrict__ slots,
                   const int* __restrict__ counts, float4* spill,
                   long long* spill_cls, unsigned char* __restrict__ keep,
                   int K, int Kp, int nslots, int cap, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* kbox = reinterpret_cast<float4*>(smem);
  // the tile's boxes, one float4 of padding after each 32: the items of
  // the cross test read eight words at once, each from its own banks
  float4* tbox = kbox + cap;
  auto tb = [&](int p) -> float4& { return tbox[p + (p >> 5)]; };
  float* tarea = reinterpret_cast<float*>(tbox + kTile + kWords);
  auto ta = [&](int p) -> float& { return tarea[p + (p >> 5)]; };
  long long* kcls = reinterpret_cast<long long*>(tarea + kTile + kWords);
  long long* tcls = kcls + (kClassTest ? cap : 0);
  int* tidx = reinterpret_cast<int*>(tcls + (kClassTest ? kTile : 0));
  int* surv = tidx + kTile;
  unsigned* smask = reinterpret_cast<unsigned*>(surv + kTile);
  unsigned* sup2 = smask + kTile * kWords;  // this block's, by tile parity
  unsigned* sup = sup2 + 2 * kWords;        // the cluster's
  unsigned* kbits = sup + kWords;
  int* warp_sums = reinterpret_cast<int*>(kbits + kWords);
  int* misc = warp_sums + 32;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool zero_hit = 0.0f > thresh;   // IoU 0 overlaps below 0
  const bool filter = thresh >= 0x1p-20f && thresh <= 0x1p20f;
  // a cluster of csize blocks takes one segment: block `crank` holds kept
  // boxes crank, crank + csize, ... (a launch without clusters: csize 1)
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  // the largest segments first: with class segments (up to kTile * kWords
  // of them), cluster b takes the segment of rank b by member count, so
  // that a long segment never waits for a free SM behind short ones
  int seg = blockIdx.x / csize;
  const int nseg = gridDim.x / csize;
  if (slots && nseg <= kTile * kWords) {
    int* sc = reinterpret_cast<int*>(smask);
    for (int s = tid; s < nseg; s += kThreads) sc[s] = counts[s];
    __syncthreads();
    const int b = seg;
    for (int s = tid; s < nseg; s += kThreads) {
      const int cs = sc[s];
      int rank = 0;
      for (int o = 0; o < nseg; ++o)
        rank += sc[o] > cs || (sc[o] == cs && o < s);
      if (rank == b) misc[1] = s;
    }
    __syncthreads();
    seg = misc[1];
    __syncthreads();  // smask is the survivors' mask from here on
  }
  const int g = seg / nslots, slot = seg % nslots;
  const int n = static_cast<int>(nvalid[g]);
  const int cnt = slots ? counts[seg] : n;
  if (cnt == 0) return;

  // where this segment's kept boxes past `cap` go: its members' share of
  // the image's K spill rows (the members of earlier slots come first)
  int before = 0;
  if (slots) {
    int part = 0;
    for (int s = tid; s < slot; s += kThreads)
      part += counts[static_cast<size_t>(g) * nslots + s];
    int total;
    block_scan<kThreads>(part, warp_sums, &total);
    before = total;
  }
  const size_t row = static_cast<size_t>(g) * K;
  float4* sp = spill + row + before;
  long long* spc = kClassTest ? spill_cls + row + before : nullptr;
  const float4* bx = boxes + row;
  const long long* cl = classes + row;
  const unsigned short* sl = slots ? slots + static_cast<size_t>(g) * Kp
                                   : nullptr;
  unsigned char* out = keep + row;

  // this block's kept boxes: shared memory to `cap`, then the spill rows
  // (the segment's kept box q = j * csize + crank at q - cap * csize)
  auto spill_at = [&](int j) { return (j - cap) * csize + crank; };
  int nkept = 0, nloc = 0, taken = 0, pos = 0, parity = 0;
  while (taken < cnt) {
    // 1. the tile's members, in order
    int fill;
    if (!sl) {
      fill = min(kTile, cnt - taken);
      for (int t = tid; t < fill; t += kThreads) tidx[t] = taken + t;
    } else {
      fill = 0;
      while (fill < kTile && taken + fill < cnt) {
        const int base = (pos & ~(kIdsPerThread - 1)) + tid * kIdsPerThread;
        unsigned match = 0;
        if (base < Kp) {
          const uint4* p = reinterpret_cast<const uint4*>(sl + base);
          const uint4 u0 = p[0], u1 = p[1];
          const unsigned w[8] = {u0.x, u0.y, u0.z, u0.w,
                                 u1.x, u1.y, u1.z, u1.w};
#pragma unroll
          for (int k = 0; k < kIdsPerThread; ++k) {
            const unsigned s = (w[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu;
            if (s == static_cast<unsigned>(slot) && base + k >= pos)
              match |= 1u << k;
          }
        }
        int total;
        int r = block_scan<kThreads>(__popc(match), warp_sums, &total);
        const int room = kTile - fill;
        while (match) {
          const int k = __ffs(match) - 1;
          match &= match - 1;
          if (r < room) tidx[fill + r] = base + k;
          if (r == room - 1) misc[0] = base + k + 1;
          ++r;
        }
        __syncthreads();
        if (total > room) {
          pos = misc[0];
          fill = kTile;
        } else {
          pos = (pos & ~(kIdsPerThread - 1)) + kThreads * kIdsPerThread;
          fill += total;
        }
        __syncthreads();  // misc[0] is read before it is written again
      }
    }
    __syncthreads();

    // 2. the tile's boxes; no member suppressed yet
    for (int t = tid; t < fill; t += kThreads) {
      const float4 b = bx[tidx[t]];
      tb(t) = b;
      ta(t) = area(b);
      if (kClassTest) tcls[t] = cl[tidx[t]];
    }
    unsigned* mine = sup2 + parity * kWords;
    if (tid < kWords) mine[tid] = 0u;
    __syncthreads();

    // 3. cross test: this block's kept boxes (kPerItem a thread) against
    // the members of a 32-member word not yet suppressed (the word's bits
    // as they stand when the item starts). Neighbouring items take
    // neighbouring words of the same kept boxes, so later kept boxes skip
    // what earlier ones suppressed. A pair's IoU is decided without the
    // division where `decide` can; the pairs it cannot decide take it
    // afterwards, so that a warp runs the division for a lane's few such
    // pairs, not for every member that some lane's pair needs it for.
    const int nkg = (nloc + kPerItem - 1) / kPerItem;
    const int nmw = (fill + 31) >> 5;
    for (int item = tid; item < nkg * nmw; item += kThreads) {
      const int mw = item % nmw, j0 = item / nmw * kPerItem;
      float4 a[kPerItem];
      float aa[kPerItem];
      long long c[kPerItem];
      bool has[kPerItem];
#pragma unroll
      for (int r = 0; r < kPerItem; ++r) {
        const int j = j0 + r;
        has[r] = j < nloc;
        const int jj = has[r] ? j : j0;
        a[r] = jj < cap ? kbox[jj] : sp[spill_at(jj)];
        aa[r] = area(a[r]);
        c[r] = kClassTest ? (jj < cap ? kcls[jj] : spc[spill_at(jj)]) : 0;
      }
      const int m0 = mw * 32, mend = min(32, fill - m0);
      unsigned todo = (mend == 32 ? 0xffffffffu : (1u << mend) - 1u)
          & ~*static_cast<volatile unsigned*>(&mine[mw]);
      unsigned bits = 0u, divide[kPerItem];
#pragma unroll
      for (int r = 0; r < kPerItem; ++r) divide[r] = 0u;
      while (todo) {
        const int m = __ffs(todo) - 1;
        const unsigned bit = 1u << m;
        todo &= todo - 1u;
        const float4 b = tb(m0 + m);
        const float ab = ta(m0 + m);
        const long long cm = kClassTest ? tcls[m0 + m] : 0;
#pragma unroll
        for (int r = 0; r < kPerItem; ++r) {
          const bool take = has[r] && (!kClassTest || c[r] == cm);
          const Verdict v = decide(intersection(a[r], b), aa[r], ab, thresh,
                                   filter, zero_hit);
          bits |= take && v == kOverlap ? bit : 0u;
          divide[r] |= take && v == kDivide ? bit : 0u;
        }
      }
#pragma unroll
      for (int r = 0; r < kPerItem; ++r) {
        unsigned d = divide[r] & ~bits;
        while (d) {
          const int m = __ffs(d) - 1;
          d &= d - 1u;
          const float4 b = tb(m0 + m);
          if (overlaps_from(a[r], b, intersection(a[r], b), thresh))
            bits |= 1u << m;
        }
      }
      if (bits) atomicOr(&mine[mw], bits);
    }
    // every block's bits of this tile are final; each block ORs them all
    // (a block rewrites these bits two tiles on, after the next barrier)
    cluster.sync();
    if (tid < kWords) {
      unsigned v = 0u;
      for (int r = 0; r < csize; ++r)
        v |= cluster.map_shared_rank(mine, r)[tid];
      sup[tid] = v;
    }
    __syncthreads();

    // 4. the survivors, in order: a member's rank among them from the bits
    int S = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int lo = w * 32;
      const unsigned live = lo >= fill ? 0u
          : (fill - lo >= 32 ? 0xffffffffu : (1u << (fill - lo)) - 1u);
      const unsigned alive = live & ~sup[w];
      if (tid >= lo && tid < lo + 32 && ((alive >> (tid - lo)) & 1u))
        surv[S + __popc(alive & ((1u << (tid - lo)) - 1u))] = tid;
      S += __popc(alive);
    }
    __syncthreads();

    // 5. the survivors' overlap bits: row s, bit u set when u > s overlaps
    const int W = (S + 31) >> 5;
    for (int item = tid; item < S * W; item += kThreads) {
      const int s = item / W, w = item % W;
      unsigned bits = 0u;
      if (w >= (s >> 5)) {
        const float4 a = tb(surv[s]);
        const float aa = ta(surv[s]);
        const int ulo = max(w * 32, s + 1), uhi = min(w * 32 + 32, S);
        for (int u = ulo; u < uhi; ++u) {
          const int pu = surv[u];
          if (kClassTest && tcls[surv[s]] != tcls[pu]) continue;
          const float4 b = tb(pu);
          const float inter = intersection(a, b);
          const Verdict v = decide(inter, aa, ta(pu), thresh, filter,
                                   zero_hit);
          if (v == kOverlap
              || (v == kDivide && overlaps_from(a, b, inter, thresh)))
            bits |= 1u << (u - w * 32);
        }
      }
      smask[s * kWords + w] = bits;
    }
    __syncthreads();

    // 6. one warp walks the survivors: kept unless a kept one removed it
    if (warp == 0) {
      unsigned removed = 0u, kept = 0u;
      for (int s = 0; s < S; ++s) {
        const unsigned word = __shfl_sync(0xffffffffu, removed, s >> 5);
        if (!((word >> (s & 31)) & 1u)) {
          if (lane == (s >> 5)) kept |= 1u << (s & 31);
          if (lane < W) removed |= smask[s * kWords + lane];
        }
      }
      if (lane < kWords) kbits[lane] = kept;
    }
    __syncthreads();

    // 7. the kept survivors join the kept set (kept box q to block
    // q % csize); their keep bytes
    int added = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const unsigned kw = kbits[w];
      const int lo = w * 32;
      if (tid >= lo && tid < lo + 32 && ((kw >> (tid - lo)) & 1u)) {
        const int q = nkept + added + __popc(kw & ((1u << (tid - lo)) - 1u));
        const int p = surv[tid];
        if (q % csize == crank) {
          const int j = q / csize;
          const float4 b = tb(p);
          if (j < cap) {
            kbox[j] = b;
            if (kClassTest) kcls[j] = tcls[p];
          } else {
            sp[spill_at(j)] = b;
            if (kClassTest) spc[spill_at(j)] = tcls[p];
          }
        }
        if (crank == 0) out[tidx[p]] = 1;
      }
      added += __popc(kw);
    }
    nkept += added;
    nloc = (nkept - crank + csize - 1) / csize;
    taken += fill;
    parity ^= 1;
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may read its bits
}

template <int kThreads, bool kClassTest>
cudaError_t launch_segments(int nseg, int csize, size_t smem, cudaStream_t s,
                            const float4* boxes, const long long* classes,
                            const long long* nvalid,
                            const unsigned short* slots, const int* counts,
                            float4* spill, long long* spill_cls,
                            unsigned char* keep, int K, int Kp, int nslots,
                            int cap, float thresh) {
  auto kernel = nms_segment_kernel<kThreads, kClassTest>;
  // all of the SM's 228 KB as shared memory, so that its share of the
  // segments' blocks runs side by side, not one after another; the
  // opt-in maximum of dynamic shared memory. Set once an instance.
  static bool configured = false;
  cudaError_t err = cudaSuccess;
  if (!configured) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nseg * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, boxes, classes, nvalid, slots,
                           counts, spill, spill_cls, keep, K, Kp, nslots,
                           cap, thresh);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The most kept boxes a segment block holds in shared memory.
int nms_max_kept(int class_test) {
  const Layout L = layout(class_test != 0);
  return (kMaxSmem - L.fixed) / L.per_kept;
}

// The prepare kernel, then a cluster of `csize` blocks (1 to 8) of
// `threads` (256 or 512) a segment over G images.
//   slots, counts: (G, Kp) uint16 and (G, nslots) int32 zeroed, when
//     segments are classes (cls0 the smallest class, nslots the range);
//     null otherwise (nslots 1: a segment is an image)
//   spill, spill_cls: (G, K) float4 and int64 rows for the kept boxes past
//     `cap` a block (spill_cls only with class_test)
int nms_forward(const void* boxes, const void* classes, const void* nvalid,
                void* slots, void* counts, void* spill, void* spill_cls,
                void* keep, int G, int K, int Kp, int nslots,
                long long cls0, int class_test, int csize, int threads,
                int cap, float thresh, void* stream) {
  if (G <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool partition = slots != nullptr;
  const dim3 pgrid((Kp + kPrepChunk - 1) / kPrepChunk, G);
  nms_prepare_kernel<<<pgrid, kPrepThreads,
                       partition ? nslots * sizeof(int) : 0, s>>>(
      static_cast<const long long*>(classes),
      static_cast<const long long*>(nvalid),
      static_cast<unsigned short*>(slots),
      static_cast<int*>(counts), static_cast<unsigned char*>(keep), K, Kp,
      cls0, nslots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout L = layout(class_test != 0);
  const size_t smem = static_cast<size_t>(L.fixed)
      + static_cast<size_t>(cap) * L.per_kept;
  if (cap < 1 || smem > static_cast<size_t>(kMaxSmem) || csize < 1
      || csize > 8 || (threads != 256 && threads != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch = threads == 512
      ? (class_test ? launch_segments<512, true> : launch_segments<512, false>)
      : (class_test ? launch_segments<256, true>
                    : launch_segments<256, false>);
  return static_cast<int>(launch(
      G * nslots, csize, smem, s, static_cast<const float4*>(boxes),
      static_cast<const long long*>(classes),
      static_cast<const long long*>(nvalid),
      static_cast<const unsigned short*>(slots),
      static_cast<const int*>(counts), static_cast<float4*>(spill),
      static_cast<long long*>(spill_cls), static_cast<unsigned char*>(keep),
      K, Kp, nslots, cap, thresh));
}

}  // extern "C"
