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
// written, one flop or two per element). One thread per element with a
// grid-stride loop, so any grid covers n; the default launch (block 256,
// grid ceil(n / 256)) gives each thread one element. __fmul_rn/__fadd_rn
// keep a*b+c from contracting into one FMA, so each operation rounds as
// torch's separate kernels round it and the f32 outputs agree bit for bit.

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

#define GRID_STRIDE(i, n)                                              \
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; \
       i < (n); i += (long long)gridDim.x * blockDim.x)

template <typename T>
__device__ __forceinline__ void double_body(const float* __restrict__ x,
                                            T* __restrict__ out,
                                            long long n) {
  GRID_STRIDE(i, n) out[i] = cast_out<T>(__fmul_rn(x[i], 2.0f));
}

template <typename T>
__device__ __forceinline__ void scale_shift_body(const float* __restrict__ x,
                                                 T* __restrict__ out,
                                                 long long n) {
  GRID_STRIDE(i, n)
    out[i] = cast_out<T>(__fadd_rn(__fmul_rn(x[i], 4.0f), -1.0f));
}

template <typename T>
__device__ __forceinline__ void saxpy_body(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           T* __restrict__ out,
                                           long long n) {
  GRID_STRIDE(i, n)
    out[i] = cast_out<T>(__fadd_rn(__fmul_rn(2.5f, x[i]), y[i]));
}

extern "C" __global__ void double_f32(const float* x, float* out,
                                      long long n) {
  double_body(x, out, n);
}
extern "C" __global__ void double_bf16(const float* x, unsigned short* out,
                                       long long n) {
  double_body(x, out, n);
}
extern "C" __global__ void double_i32(const float* x, int* out,
                                      long long n) {
  double_body(x, out, n);
}

extern "C" __global__ void scale_shift_f32(const float* x, float* out,
                                           long long n) {
  scale_shift_body(x, out, n);
}
extern "C" __global__ void scale_shift_bf16(const float* x,
                                            unsigned short* out,
                                            long long n) {
  scale_shift_body(x, out, n);
}
extern "C" __global__ void scale_shift_i32(const float* x, int* out,
                                           long long n) {
  scale_shift_body(x, out, n);
}

extern "C" __global__ void saxpy_f32(const float* x, const float* y,
                                     float* out, long long n) {
  saxpy_body(x, y, out, n);
}
extern "C" __global__ void saxpy_bf16(const float* x, const float* y,
                                      unsigned short* out, long long n) {
  saxpy_body(x, y, out, n);
}
extern "C" __global__ void saxpy_i32(const float* x, const float* y,
                                     int* out, long long n) {
  saxpy_body(x, y, out, n);
}
