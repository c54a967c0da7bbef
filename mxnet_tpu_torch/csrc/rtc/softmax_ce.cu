// User device code for mxnet_tpu_torch.rtc.CudaKernel (NVRTC, sm_90a):
// the softmax cross-entropy head `rtc_softmax_ce` (rtc_ops.SoftmaxCE), a
// custom op that replaces SoftmaxOutput, as the numpy CustomOp of
// examples/numpy_ops/custom_softmax.py does in the JAX package, where such
// device code is a Pallas body run by mxnet_tpu/rtc.py PallasKernel.push.
// Plain PyTorch versions: mxnet_tpu_torch/rtc_ops.py.
//
// ABI (rtc.CudaKernel): pointers to the inputs, then to the output, then
// the output's element count n. Both kernels run one CTA per row: rows =
// gridDim.x and the row length is n / rows. Blocks are whole warps, up to
// 1024 threads.
//
//   softmax_ce_forward(x, prob, n)          prob = softmax(x) over each row
//   softmax_ce_backward(prob, label, grad, n)
//       grad = prob - onehot(label): labels arrive as float32 and are
//       truncated toward zero (torch's .to(torch.int64)); a label outside
//       [0, cols) subtracts nothing. This is SoftmaxOutput's gradient with
//       its defaults (grad_scale 1, normalization "null": unnormalized),
//       bit for bit given the same prob.
//
// Bound: bytes, each row read once and written once (7 float32 operations
// an element forward, far under the card's rate). The forward's design:
//  - Register-resident rows. Each thread loads one float4 of the row, or
//    up to SOFTMAX_VEC of them (16-byte loads, 4 * SOFTMAX_VEC floats in
//    registers), takes the max and then the sum of exp(x - max) from those
//    registers and writes exp(x - max) / sum from them: one read and one
//    write of HBM, the bound. A row of up to 4 * SOFTMAX_VEC * 1024 floats
//    (32,768, 64 registers a thread, no spills) stays in registers.
//  - Short rows (up to 4 floats a thread) take the one-float4 code. Such
//    a launch runs each SM's code once, from a cold instruction cache,
//    where the unrolled SOFTMAX_VEC code costs about 1 us more.
//  - Reductions. Warp shuffles, one partial a warp in shared memory, one
//    barrier, then every warp folds all of the row's partials in the same
//    order, so every thread holds the same bits. A one-warp CTA reduces
//    with shuffles only, with no barrier at all.
//  - Longer rows stream twice: one pass carries each thread's (max, sum)
//    and rescales the sum when the max grows, chunk by chunk of
//    SOFTMAX_VEC / 2 float4s a thread; the second writes. Two reads and
//    one write.
//  - Rows whose length is not a multiple of 4, or whose start is not
//    16-byte aligned, load scalars: up to 4 floats a thread in registers,
//    longer rows on the online path (scalar code for SOFTMAX_VEC float4s
//    a thread spilled, and the whole kernel's allocation with it).
// rtc_ops.softmax_geometry picks the block, and so the path, from the row
// length. The backward reads and writes float4s, BWD_UNROLL loads in
// flight a thread (one pass over a vocabulary-sized row in a 1024-thread
// CTA), and subtracts 1 only in the one float4 that holds the label.

#define FULL_MASK 0xffffffffu
#define NEG_INF __int_as_float(0xff800000)   // NVRTC has no math.h
#define SOFTMAX_VEC 8     // float4s a thread holds (rtc_ops.SOFTMAX_VEC)
#define BWD_UNROLL 8      // float4s a thread loads before it stores

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// The max (IS_MAX) or the sum of v over every thread of the CTA. part
// holds 32 floats; each reduction of a launch uses its own.
template <bool IS_MAX>
__device__ __forceinline__ float row_reduce(float v, float* part) {
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  const unsigned nwarps = blockDim.x >> 5;
  if (nwarps == 1) return v;
  const unsigned lane = threadIdx.x & 31;
  if (lane == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  const float w = lane < nwarps ? part[lane] : (IS_MAX ? NEG_INF : 0.0f);
  return IS_MAX ? warp_max(w) : warp_sum(w);
}

// Units of a row: float4s (V4) or floats. `seg` is the first unit of a
// run of `count`; slot k of thread t holds unit k * blockDim.x + t, and a
// slot past count holds -inf (exp gives 0). Offsets within a run are 32
// bits (a run is at most one CTA's registers or one chunk).
template <bool V4, int VEC>
__device__ __forceinline__ void load_slots(const float* __restrict__ seg,
                                           unsigned count, float* r) {
  constexpr int LOADS = V4 ? VEC : 4 * VEC;
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const unsigned j = k * blockDim.x + threadIdx.x;
    if constexpr (V4) {
      const float4 q = j < count ? reinterpret_cast<const float4*>(seg)[j]
                                 : make_float4(NEG_INF, NEG_INF, NEG_INF,
                                               NEG_INF);
      r[4 * k] = q.x;
      r[4 * k + 1] = q.y;
      r[4 * k + 2] = q.z;
      r[4 * k + 3] = q.w;
    } else {
      r[k] = j < count ? seg[j] : NEG_INF;
    }
  }
}

// Writes r / s to the slots that load_slots filled.
template <bool V4, int VEC>
__device__ __forceinline__ void store_slots(float* __restrict__ seg,
                                            unsigned count, const float* r,
                                            float s) {
  constexpr int LOADS = V4 ? VEC : 4 * VEC;
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const unsigned j = k * blockDim.x + threadIdx.x;
    if (j < count) {
      if constexpr (V4) {
        reinterpret_cast<float4*>(seg)[j] =
            make_float4(r[4 * k] / s, r[4 * k + 1] / s, r[4 * k + 2] / s,
                        r[4 * k + 3] / s);
      } else {
        seg[j] = r[k] / s;
      }
    }
  }
}

// The row's `count` units, from `xr` (written to `pr`), fit in the CTA's
// registers: VEC float4s a thread (4 * VEC floats).
template <bool V4, int VEC>
__device__ __forceinline__ void softmax_in_registers(
    const float* __restrict__ xr, float* __restrict__ pr, unsigned count,
    float* part_max, float* part_sum) {
  constexpr int PER = V4 ? 4 : 1;            // floats a slot
  float r[4 * VEC];
  load_slots<V4, VEC>(xr, count, r);
  float m = NEG_INF;
#pragma unroll
  for (int i = 0; i < 4 * VEC; ++i) m = fmaxf(m, r[i]);
  m = row_reduce<true>(m, part_max);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4 * VEC; ++i) {
    // slots past the row (the same for every thread) hold -inf
    if ((i / PER) * blockDim.x < count) {
      r[i] = expf(r[i] - m);
      s += r[i];
    }
  }
  s = row_reduce<false>(s, part_sum);
  store_slots<V4, VEC>(pr, count, r, s);
}

// Longer rows: a pass of (max, sum) pairs, chunk by chunk of half the
// register path's slots, then a pass that writes.
template <bool V4>
__device__ __forceinline__ void softmax_online(
    const float* __restrict__ xr, float* __restrict__ pr, long long count,
    float* part_max, float* part_sum) {
  constexpr int VEC = SOFTMAX_VEC / 2;
  const long long chunk = (V4 ? VEC : 4 * VEC) * (long long)blockDim.x;
  const long long unit = V4 ? 4 : 1;
  float r[4 * VEC];
  float m = NEG_INF, s = 0.0f;
  for (long long base = 0; base < count; base += chunk) {
    const unsigned left = count - base < chunk ? count - base : chunk;
    load_slots<V4, VEC>(xr + base * unit, left, r);
    float cm = m;
#pragma unroll
    for (int i = 0; i < 4 * VEC; ++i) cm = fmaxf(cm, r[i]);
    if (cm == NEG_INF) continue;           // nothing but -inf so far
    float cs = 0.0f;
#pragma unroll
    for (int i = 0; i < 4 * VEC; ++i) cs += expf(r[i] - cm);
    s = s * expf(m - cm) + cs;             // m == -inf: s is 0
    m = cm;
  }
  const float row_m = row_reduce<true>(m, part_max);
  s = row_reduce<false>(m == NEG_INF ? 0.0f : s * expf(m - row_m),
                        part_sum);
  for (long long base = 0; base < count; base += chunk) {
    const unsigned left = count - base < chunk ? count - base : chunk;
    load_slots<V4, VEC>(xr + base * unit, left, r);
#pragma unroll
    for (int i = 0; i < 4 * VEC; ++i) r[i] = expf(r[i] - row_m);
    store_slots<V4, VEC>(pr + base * unit, left, r, s);
  }
}

extern "C" __launch_bounds__(1024) __global__ void softmax_ce_forward(
    const float* __restrict__ x, float* __restrict__ prob, long long n) {
  __shared__ float part_max[32], part_sum[32];
  const long long cols = n / gridDim.x;
  const float* xr = x + blockIdx.x * cols;
  float* pr = prob + blockIdx.x * cols;
  // the path: one float4 (or four floats) a thread, SOFTMAX_VEC of them,
  // or the online path
  const unsigned threads = blockDim.x;
  if ((cols & 3) == 0
      && ((reinterpret_cast<unsigned long long>(xr)
           | reinterpret_cast<unsigned long long>(pr)) & 15) == 0) {
    const long long quads = cols >> 2;
    if (quads <= threads)
      softmax_in_registers<true, 1>(xr, pr, quads, part_max, part_sum);
    else if (quads <= SOFTMAX_VEC * threads)
      softmax_in_registers<true, SOFTMAX_VEC>(xr, pr, quads, part_max,
                                              part_sum);
    else
      softmax_online<true>(xr, pr, quads, part_max, part_sum);
  } else {
    if (cols <= 4 * threads)
      softmax_in_registers<false, 1>(xr, pr, cols, part_max, part_sum);
    else
      softmax_online<false>(xr, pr, cols, part_max, part_sum);
  }
}

extern "C" __launch_bounds__(1024) __global__ void softmax_ce_backward(
    const float* __restrict__ prob, const float* __restrict__ label,
    float* __restrict__ grad, long long n) {
  const long long cols = n / gridDim.x;
  const long long row = blockIdx.x;
  const float* pr = prob + row * cols;
  float* gr = grad + row * cols;
  const long long lab = (long long)label[row];
  const long long step = blockDim.x;
  if ((cols & 3) == 0
      && ((reinterpret_cast<unsigned long long>(pr)
           | reinterpret_cast<unsigned long long>(gr)) & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(pr);
    float4* g4 = reinterpret_cast<float4*>(gr);
    const long long c4 = cols >> 2;
    for (long long base = threadIdx.x; base < c4;
         base += BWD_UNROLL * step) {
      float4 v[BWD_UNROLL];
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        const long long j = base + u * step;
        if (j < c4) v[u] = p4[j];
      }
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        const long long j = base + u * step;
        if (j < c4) {
          // the label's element, if this float4 holds it
          const unsigned long long d = (unsigned long long)lab
              - 4ull * (unsigned long long)j;
          if (d == 0) v[u].x = v[u].x - 1.0f;
          else if (d == 1) v[u].y = v[u].y - 1.0f;
          else if (d == 2) v[u].z = v[u].z - 1.0f;
          else if (d == 3) v[u].w = v[u].w - 1.0f;
          g4[j] = v[u];
        }
      }
    }
  } else {
    for (long long j = threadIdx.x; j < cols; j += step)
      gr[j] = j == lab ? pr[j] - 1.0f : pr[j];
  }
}
