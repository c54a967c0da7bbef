// Blockwise (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package:
//   mxnet_tpu/parallel/attention.py  _flash_fwd_kernel (:48), launched by
//   _flash_forward (:92) behind attention(..., impl="flash").
//
// Contract (the same as flash_forward_plain in
// mxnet_tpu_torch/parallel/attention.py):
//   q    (B, Tq, H, D)   float32, bfloat16 or float16
//   k, v (B, Tk, H, D)   the same dtype as q
//   o    (B, Tq, H, D)   the same dtype as q
// Each tensor is read and written through its own (batch, seq, head)
// strides in elements; the head_dim axis is contiguous. So the public
// (B, T, H, D) layout is used as it is, without the reference's three
// transposes into (B*H, T, D).
//   s = (q . k) * scale in float32, masked to -1e30 where causal and
//       k_pos > q_pos (the kernel's top-left alignment, as the TPU kernel
//       has it; the XLA reference aligns bottom-right, so the two differ
//       when Tq != Tk -- the port copies both);
//   p = exp(s - m) with an online (running) max m and sum l per row;
//   o = (sum_k p . v) / l, cast to q's dtype once at the end.
// In bf16/f16 p is rounded to v's dtype before the PV product, as the TPU
// kernel's p.astype(v.dtype) does; all arithmetic is full float32 (no
// TF32, no tensor cores), with expf, not the fast-math exponential.
//
// Design. The TPU kernel walks a (B*H, Tq/block_q) grid and, inside one
// program, streams K/V blocks from HBM with the softmax state carried in
// a fori_loop. Here one block of 128 threads owns one (batch*head, tile of
// 64 query rows) pair and loops over 64-key tiles of K and V itself:
//   1. the Q tile (64 x D) is staged once in shared memory as float32;
//   2. per key tile, the 128 threads stage K and V (64 x D each) in shared
//      memory as float32 (zero past Tk and past D);
//   3. thread (ty, tx) = (tid / 8, tid % 8) computes the scores of rows
//      4*ty .. 4*ty+3 and keys tx, tx+8, .., tx+56 (32 in registers); the
//      8 threads of a row group meet by warp shuffles for the row max and
//      row sum; each thread rescales its own slice of the float32 output
//      accumulator (the same rows, columns tx, tx+8, ..: D/2 registers) by
//      exp(m_old - m_new) and writes its probabilities to shared memory;
//   4. after a barrier the same thread adds P[rows, :] . V[:, cols] to its
//      accumulator.
// Rows of Q and K in shared memory are padded by one float, so the 4 rows
// and 8 keys a warp reads at one head_dim index fall in distinct banks.
// head_dim is a template parameter (16, 32, 64, 128, 256; a head_dim in
// between runs in the next one up, zero-padded), so the accumulator loops
// unroll into registers. With causal, a tile stops at the last key its
// last row can see; the tiles past it would add exactly 0 (exp(-1e30 - m)
// is 0), so the result is the same. Causal tiles are launched longest
// first (the grid's y index counts down from the last query tile).
// Shared memory: 64 (D+1) Q + 64 (D+1) K + 64 D V + 64 x 65 P floats,
// 66 KB at D = 64 and 209 KB at D = 256, set as the kernel's dynamic
// shared memory limit before each launch.
//
// Bound. Per (batch, head) the kernel must read Q, K, V and write O once,
// (2 Tq + 2 Tk) D elements, and do 4 Tq Tk D flops (2 for QK^T, 2 for PV;
// half when causal). At the transformer's shape (B 8, T 2048, H 8, D 64,
// causal) that is 3.4e10 flops against 134 MB in float32: 0.51 ms at the
// float32 rate outside the tensor cores (67 TFLOP/s) and 0.04 ms at the HBM
// rate, so the float32 kernel is bound by operations; bf16 is the same on
// this design (it runs float32 SIMT arithmetic), while the card's bound
// for bf16 work is its tensor-core rate (989 TFLOP/s, 0.035 ms). What
// this design does about it: every K/V element staged in shared memory
// serves 64 query rows, and every score or output element a thread holds
// is reused from registers, so the arithmetic, not memory, is the limit.
// It is a simple SIMT kernel: mma.sync / wgmma on the tensor cores, TMA or
// cp.async staging overlapped with the arithmetic, and a backward kernel
// are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (mxnet_tpu_torch/kernels.py does this at first use).
// The entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a head_dim or dtype it does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kRowsPerThread = 4;   // 16 row groups x 4 rows = 64
constexpr int kColThreads = 8;      // threads sharing a row group
constexpr int kKeysPerThread = kTileK / kColThreads;  // 8

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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

// p rounded to the input dtype (identity in float32), as p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Strides {
  int64_t b, t, h;  // in elements; the head_dim stride is 1
};

template <int kD>
constexpr int smem_floats() {
  return kTileQ * (kD + 1) + kTileK * (kD + 1) + kTileK * kD +
         kTileQ * (kTileK + 1);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int H,
    int Tq, int Tk, int D, float scale, int causal) {
  constexpr int kQS = kD + 1;     // padded row strides (floats)
  constexpr int kKS = kD + 1;
  constexpr int kPS = kTileK + 1;
  constexpr int kCols = kD / kColThreads;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                       // (64, D+1)
  float* k_s = q_s + kTileQ * kQS;         // (64, D+1)
  float* v_s = k_s + kTileK * kKS;         // (64, D)
  float* p_s = v_s + kTileK * kD;          // (64, 65)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_qt = gridDim.y;
  const int qt = n_qt - 1 - blockIdx.y;  // longest causal tiles first
  const int q0 = qt * kTileQ;
  const int tid = threadIdx.x;
  const int ty = tid / kColThreads;
  const int tx = tid - ty * kColThreads;
  const int r0 = ty * kRowsPerThread;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // 1. the Q tile, zero past Tq and past D
  for (int i = tid; i < kTileQ * kD; i += kThreads) {
    const int r = i / kD;
    const int c = i - r * kD;
    const int t = q0 + r;
    q_s[r * kQS + c] =
        (t < Tq && c < D) ? to_float(qb[t * sq.t + c]) : 0.0f;
  }

  float acc[kRowsPerThread][kCols];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // keys this tile needs: all, or (causal) up to its last row's position
  int k_end = Tk;
  if (causal) k_end = min(Tk, min(q0 + kTileQ, Tq));
  const int n_kt = (k_end + kTileK - 1) / kTileK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    // 2. the K and V tiles
    for (int i = tid; i < kTileK * kD; i += kThreads) {
      const int r = i / kD;
      const int c = i - r * kD;
      const int t = k0 + r;
      const bool in = t < Tk && c < D;
      k_s[r * kKS + c] = in ? to_float(kb[t * sk.t + c]) : 0.0f;
      v_s[r * kD + c] = in ? to_float(vb[t * sv.t + c]) : 0.0f;
    }
    __syncthreads();

    // 3. scores of rows r0..r0+3, keys tx + 8 j
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = q_s[(r0 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = k_s[(tx + kColThreads * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kpos = k0 + tx + kColThreads * j;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos) x = kNegInf;
        if (kpos >= Tk) x = -INFINITY;  // outside the sequence: weight 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kColThreads; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(r0 + i) * kPS + tx + kColThreads * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 1; off < kColThreads; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // 4. acc[rows, tx + 8 j] += P[rows, :] . V[:, tx + 8 j]
#pragma unroll 2
    for (int c = 0; c < kTileK; ++c) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = p_s[(r0 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = v_s[c * kD + tx + kColThreads * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

  // divide, then cast to q's dtype
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = q0 + r0 + i;
    if (t >= Tq) continue;
    const float inv_l = l[i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + kColThreads * j;
      if (c < D) ob[t * so.t + c] = from_float<T>(acc[i][j] / inv_l);
    }
  }
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int H, int Tq, int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<kD>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kTileQ - 1) / kTileQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H, Tq,
      Tk, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       Strides sq, Strides sk, Strides sv, Strides so, int B,
                       int H, int Tq, int Tk, int D, float scale, int causal,
                       cudaStream_t stream) {
#define MX_FLASH_CASE(DP)                                                   \
  if (D <= DP)                                                              \
    return launch<T, DP>(q, k, v, o, sq, sk, sv, so, B, H, Tq, Tk, D, scale, \
                         causal, stream);
  MX_FLASH_CASE(16)
  MX_FLASH_CASE(32)
  MX_FLASH_CASE(64)
  MX_FLASH_CASE(128)
  MX_FLASH_CASE(256)
#undef MX_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Strides are (batch, seq, head)
// in elements for q, k, v and o in that order (12 values).
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, const int64_t* strides, int B, int H,
                            int Tq, int Tk, int D, float scale, int causal,
                            int dtype, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tk < 1)
    return cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(q, k, v, o, sq, sk, sv, so, B, H, Tq, Tk, D,
                               scale, causal, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, sq, sk, sv, so, B, H, Tq,
                                       Tk, D, scale, causal, s);
    case 2:
      return dispatch_d<__half>(q, k, v, o, sq, sk, sv, so, B, H, Tq, Tk, D,
                                scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
