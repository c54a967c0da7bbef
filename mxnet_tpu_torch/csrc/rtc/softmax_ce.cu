// User device code for mxnet_tpu_torch.rtc.CudaKernel (NVRTC, sm_90a):
// the softmax cross-entropy head `rtc_softmax_ce` (rtc_ops.SoftmaxCE), a
// custom op that replaces SoftmaxOutput, as the numpy CustomOp of
// examples/numpy_ops/custom_softmax.py does in the JAX package, where such
// device code is a Pallas body run by mxnet_tpu/rtc.py PallasKernel.push.
// Plain PyTorch versions: mxnet_tpu_torch/rtc_ops.py.
//
// ABI (rtc.CudaKernel): pointers to the inputs, then to the output, then
// the output's element count n. Both kernels are launched with one block
// per row (grid = rows, any block of whole warps up to 1024 threads), so
// rows = gridDim.x and the row length is n / gridDim.x.
//
//   softmax_ce_forward(x, prob, n)          prob = softmax(x) over each row
//   softmax_ce_backward(prob, label, grad, n)
//       grad = prob - onehot(label): labels arrive as float32 and are
//       truncated toward zero (torch's .to(torch.int64)); a label outside
//       [0, cols) subtracts nothing. This is SoftmaxOutput's gradient with
//       its defaults (grad_scale 1, normalization "null": unnormalized),
//       bit for bit given the same prob.
//
// Bound: bytes. The forward reads each row twice (max, then exp-sum) and
// a third time to write exp(x - max) / sum; at the training shape
// (32, 1000) a row is 4 KB and the re-reads hit L1/L2, at (8192, 32000) a
// row is 128 KB and they hit L2. Reductions: warp shuffles, then one
// value per warp through shared memory. Rows whose length is a multiple
// of 4 and whose start is 16-byte aligned move float4s.

#define FULL_MASK 0xffffffffu
#define NEG_INF __int_as_float(0xff800000)   // NVRTC has no math.h

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// The block's reduction of v (max when is_max, else sum); every thread
// gets the result. smem holds 33 floats.
__device__ __forceinline__ float block_reduce(float v, bool is_max,
                                              float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? smem[lane] : (is_max ? NEG_INF : 0.0f);
    w = is_max ? warp_max(w) : warp_sum(w);
    if (lane == 0) smem[32] = w;
  }
  __syncthreads();
  const float r = smem[32];
  __syncthreads();   // smem is reused by the next reduction
  return r;
}

extern "C" __global__ void softmax_ce_forward(const float* __restrict__ x,
                                              float* __restrict__ prob,
                                              long long n) {
  __shared__ float smem[33];
  const long long cols = n / gridDim.x;
  const float* xr = x + (long long)blockIdx.x * cols;
  float* pr = prob + (long long)blockIdx.x * cols;
  const bool vec = (cols % 4 == 0)
      && ((reinterpret_cast<unsigned long long>(xr) & 15) == 0)
      && ((reinterpret_cast<unsigned long long>(pr) & 15) == 0);
  const float4* x4 = reinterpret_cast<const float4*>(xr);
  float4* p4 = reinterpret_cast<float4*>(pr);
  const long long c4 = cols / 4;

  float m = NEG_INF;
  if (vec) {
    for (long long j = threadIdx.x; j < c4; j += blockDim.x) {
      const float4 v = x4[j];
      m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    }
  } else {
    for (long long j = threadIdx.x; j < cols; j += blockDim.x)
      m = fmaxf(m, xr[j]);
  }
  m = block_reduce(m, true, smem);

  float s = 0.0f;
  if (vec) {
    for (long long j = threadIdx.x; j < c4; j += blockDim.x) {
      const float4 v = x4[j];
      s += expf(v.x - m) + expf(v.y - m) + expf(v.z - m) + expf(v.w - m);
    }
  } else {
    for (long long j = threadIdx.x; j < cols; j += blockDim.x)
      s += expf(xr[j] - m);
  }
  s = block_reduce(s, false, smem);

  if (vec) {
    for (long long j = threadIdx.x; j < c4; j += blockDim.x) {
      const float4 v = x4[j];
      p4[j] = make_float4(expf(v.x - m) / s, expf(v.y - m) / s,
                          expf(v.z - m) / s, expf(v.w - m) / s);
    }
  } else {
    for (long long j = threadIdx.x; j < cols; j += blockDim.x)
      pr[j] = expf(xr[j] - m) / s;
  }
}

extern "C" __global__ void softmax_ce_backward(
    const float* __restrict__ prob, const float* __restrict__ label,
    float* __restrict__ grad, long long n) {
  const long long cols = n / gridDim.x;
  const long long row = blockIdx.x;
  const float* pr = prob + row * cols;
  float* gr = grad + row * cols;
  const long long lab = (long long)label[row];
  for (long long j = threadIdx.x; j < cols; j += blockDim.x)
    gr[j] = j == lab ? pr[j] - 1.0f : pr[j];
}
