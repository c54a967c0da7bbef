// User device code for mxnet_tpu_torch.rtc.CudaKernel (NVRTC, sm_90a):
// the three elementwise bodies of the repo's rtc examples, which the JAX
// package runs as Pallas bodies through mxnet_tpu/rtc.py PallasKernel.push:
//   double       x * 2          tests/test_feedforward_rtc.py:86-93
//   scale_shift  x * 4 - 1      tests/test_capi_tier4.py:114-118
//   saxpy        2.5 * x + y    cpp-package/example/recordio_rtc.cc:54-57
// Plain PyTorch versions: mxnet_tpu_torch/rtc_ops.py.
//
// ABI (rtc.CudaKernel): pointers to the inputs, then to the output, then
// the output's element count n. Each body has three entry points by the
// output type the caller allocates through push(out_dtypes=...):
// <name>_f32 (float32), <name>_bf16 (bfloat16, rounded to nearest even as
// torch's .to(torch.bfloat16)) and <name>_i32 (int32, truncated toward
// zero as torch's .to(torch.int32)).
//
// Bound: bytes (4 per input element read, 4/2/4 per output element
// written, one or two flops an element). Design: when every input is
// 16-byte aligned and the output is aligned to four of its elements, each
// thread moves quads of four elements: 16-byte float4 loads, 16-byte
// stores for f32 and i32 and 8-byte stores for bf16, EW_UNROLL quads
// loaded before any is stored. A block takes tiles of EW_UNROLL * block
// contiguous quads over a grid stride; the last n % 4 elements, and every
// element of a misaligned call, go one by one. Any grid covers n, so
// rtc_ops builds these kernels with items_per_thread = 4 * EW_UNROLL and
// their default grid is one tile a block (ceil(n / (256 * 16)) blocks)
// instead of one thread an element. __fmul_rn/__fadd_rn keep a*b+c from
// contracting into one FMA, so each operation rounds as torch's separate
// kernels round it and the f32 outputs agree bit for bit.

#define EW_UNROLL 4       // quads a thread loads before it stores

__device__ __forceinline__ unsigned short f32_to_bf16_rn(float v) {
  unsigned int u = __float_as_uint(v);
  if ((u & 0x7f800000u) == 0x7f800000u && (u & 0x007fffffu))
    return (unsigned short)((u >> 16) | 0x0040u);   // NaN stays a quiet NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return (unsigned short)(u >> 16);
}

template <typename T> __device__ __forceinline__ T cast_out(float v);
template <> __device__ __forceinline__ float cast_out<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ unsigned short
cast_out<unsigned short>(float v) {
  return f32_to_bf16_rn(v);
}
template <> __device__ __forceinline__ int cast_out<int>(float v) {
  return __float2int_rz(v);
}

// Quad q of the output: elements 4q .. 4q + 3 in one store.
__device__ __forceinline__ void store_quad(float* out, long long q,
                                           float4 v) {
  reinterpret_cast<float4*>(out)[q] = v;
}
__device__ __forceinline__ void store_quad(int* out, long long q, float4 v) {
  reinterpret_cast<int4*>(out)[q] =
      make_int4(__float2int_rz(v.x), __float2int_rz(v.y),
                __float2int_rz(v.z), __float2int_rz(v.w));
}
__device__ __forceinline__ void store_quad(unsigned short* out, long long q,
                                           float4 v) {
  reinterpret_cast<uint2*>(out)[q] = make_uint2(
      f32_to_bf16_rn(v.x) | ((unsigned)f32_to_bf16_rn(v.y) << 16),
      f32_to_bf16_rn(v.z) | ((unsigned)f32_to_bf16_rn(v.w) << 16));
}

struct Double {
  static constexpr int ins = 1;
  __device__ float operator()(float a, float) const {
    return __fmul_rn(a, 2.0f);
  }
};

struct ScaleShift {
  static constexpr int ins = 1;
  __device__ float operator()(float a, float) const {
    return __fadd_rn(__fmul_rn(a, 4.0f), -1.0f);
  }
};

struct Saxpy {
  static constexpr int ins = 2;
  __device__ float operator()(float a, float b) const {
    return __fadd_rn(__fmul_rn(2.5f, a), b);
  }
};

template <typename Op, typename T>
__device__ __forceinline__ void elementwise(const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            T* __restrict__ out,
                                            long long n) {
  const Op op{};
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned long long in_bits = reinterpret_cast<unsigned long long>(x);
  if constexpr (Op::ins > 1)
    in_bits |= reinterpret_cast<unsigned long long>(y);
  long long done = 0;
  if ((in_bits & 15) == 0 && (reinterpret_cast<unsigned long long>(out)
                              & (4 * sizeof(T) - 1)) == 0) {
    // tiles of EW_UNROLL * blockDim.x contiguous quads, one a block at a
    // time over a grid stride; thread t takes quads t, t + blockDim.x, ...
    const long long quads = n >> 2;
    const long long tile = EW_UNROLL * (long long)blockDim.x;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    for (long long base = blockIdx.x * tile + threadIdx.x; base < quads;
         base += gridDim.x * tile) {
      float4 a[EW_UNROLL], b[EW_UNROLL];
#pragma unroll
      for (int u = 0; u < EW_UNROLL; ++u) {
        const long long q = base + u * (long long)blockDim.x;
        if (q < quads) {
          a[u] = x4[q];
          if constexpr (Op::ins > 1) b[u] = y4[q];
          else b[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < EW_UNROLL; ++u) {
        const long long q = base + u * (long long)blockDim.x;
        if (q < quads)
          store_quad(out, q, make_float4(op(a[u].x, b[u].x),
                                         op(a[u].y, b[u].y),
                                         op(a[u].z, b[u].z),
                                         op(a[u].w, b[u].w)));
      }
    }
    done = quads << 2;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float b = 0.0f;
    if constexpr (Op::ins > 1) b = y[i];
    out[i] = cast_out<T>(op(x[i], b));
  }
}

extern "C" __global__ void double_f32(const float* x, float* out,
                                      long long n) {
  elementwise<Double>(x, nullptr, out, n);
}
extern "C" __global__ void double_bf16(const float* x, unsigned short* out,
                                       long long n) {
  elementwise<Double>(x, nullptr, out, n);
}
extern "C" __global__ void double_i32(const float* x, int* out,
                                      long long n) {
  elementwise<Double>(x, nullptr, out, n);
}

extern "C" __global__ void scale_shift_f32(const float* x, float* out,
                                           long long n) {
  elementwise<ScaleShift>(x, nullptr, out, n);
}
extern "C" __global__ void scale_shift_bf16(const float* x,
                                            unsigned short* out,
                                            long long n) {
  elementwise<ScaleShift>(x, nullptr, out, n);
}
extern "C" __global__ void scale_shift_i32(const float* x, int* out,
                                           long long n) {
  elementwise<ScaleShift>(x, nullptr, out, n);
}

extern "C" __global__ void saxpy_f32(const float* x, const float* y,
                                     float* out, long long n) {
  elementwise<Saxpy>(x, y, out, n);
}
extern "C" __global__ void saxpy_bf16(const float* x, const float* y,
                                      unsigned short* out, long long n) {
  elementwise<Saxpy>(x, y, out, n);
}
extern "C" __global__ void saxpy_i32(const float* x, const float* y,
                                     int* out, long long n) {
  elementwise<Saxpy>(x, y, out, n);
}
