// Device helpers of the generated fusion-group kernels (B1-B3).
//
// passes/codegen.py emits one .cu file per (group digest, dtypes): a
// `chain` function evaluating the group's elementwise ops in float32
// with its scalar parameters as literals, and one of the three templates
// below around it. This header holds what every generated file shares:
// loads and stores of float32 / bf16 / fp16 with conversion to float32,
// 16-byte vector packs, the op functions whose semantics need more than
// one C expression, and deterministic block reductions.
//
// Replaces mxnet_tpu/passes/pallas_codegen.py: _elementwise_kernel (:408,
// pallas_call at :427), _scale_bias_act_kernel (:444) and
// _reduction_kernel (:455, pallas_call at :476).
//
// Bound: every template reads each external input once and writes its
// output once; a chain does a few flops per element, far below the
// card's 295 flops per byte, so the bound is bytes over 3.35 TB/s.
// Design: a grid-stride loop with 16-byte loads and stores when every
// pointer is aligned (float32: 4 elements, bf16/fp16: 8), the chain in
// registers, no shared memory. The reduction is two deterministic
// passes (per-block partials in a fixed order, then one block), with no
// atomics, so repeated runs give the same bits. The sources compile
// without multiply-add contraction (kernels.GEN_NVCC_FLAGS), so every op
// of a chain rounds as its PyTorch op does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mxf {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// N elements of T as one aligned load/store (16 bytes for the widest T)
template <int N, typename T>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <int N, typename T>
__device__ __forceinline__ void load(const T* __restrict__ p, float* out) {
  Pack<N, T> pk = *reinterpret_cast<const Pack<N, T>*>(p);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = to_f(pk.v[k]);
}

template <int N, typename T>
__device__ __forceinline__ void store(T* __restrict__ p, const float* in) {
  Pack<N, T> pk;
#pragma unroll
  for (int k = 0; k < N; ++k) pk.v[k] = from_f<T>(in[k]);
  *reinterpret_cast<Pack<N, T>*>(p) = pk;
}

// ------------------------------------------------------------- op helpers
// NaN-propagating max/min, as jnp.maximum / torch.maximum
__device__ __forceinline__ float maxf(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float minf(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}
// numpy mod: the result takes the sign of the divisor
__device__ __forceinline__ float pymod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return minf(maxf(x, lo), hi);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_f16(float x) {
  return __half2float(__float2half(x));
}

// --------------------------------------------------------- block reduce
struct SumOp {
  static __device__ __forceinline__ float init() { return 0.f; }
  static __device__ __forceinline__ float apply(float a, float b) {
    return a + b;
  }
};
struct MaxOp {
  static __device__ __forceinline__ float init() { return -INFINITY; }
  static __device__ __forceinline__ float apply(float a, float b) {
    return maxf(a, b);
  }
};
struct MinOp {
  static __device__ __forceinline__ float init() { return INFINITY; }
  static __device__ __forceinline__ float apply(float a, float b) {
    return minf(a, b);
  }
};

// Reduce one value per thread over the block, in a fixed order: warp
// shuffles, then warp 0 over the per-warp results. blockDim.x must be a
// multiple of 32, at most 1024. The result is valid in thread 0.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v) {
  __shared__ float warp_vals[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = Op::apply(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_vals[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = (threadIdx.x < n_warps) ? warp_vals[threadIdx.x] : Op::init();
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = Op::apply(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

}  // namespace mxf
