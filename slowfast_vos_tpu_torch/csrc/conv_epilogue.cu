// The epilogue of a backbone convolution for Hopper (sm_90a): K8.
//
// Replaces no TPU kernel: XLA fuses the frozen BatchNorm, the residual add
// and the ReLU into the convolution there. On the card the ResNet-50 + FPN
// backbone (`slowfast_vos_tpu_torch/models/resnet_fpn.py`) folds each frozen
// BatchNorm's scale into its convolution's weights and ends every
// convolution in this one pass. The port's plain version is
// `slowfast_vos_tpu_torch/ops/conv_epilogue.py::conv_epilogue_plain`. What
// it computes, on a convolution's output x of N rows of C channels
// (channels-last memory), in f32 with one rounding to x's dtype:
//
//   y[r, c] = act(x[r, c] + bias[c] (+ residual[r, c])),  act = identity or ReLU
//
// where the additions go in that order, as the plain version's, and the
// ReLU keeps a NaN (as `torch.relu`). y may be x itself (in place).
//
// Design: a memory-bound stream. Each thread moves 16-byte vectors (8 bf16
// or 4 f32 channels; C is a multiple of 8, so a vector never crosses a row)
// with vector loads and stores; a CTA takes tiles of kUnroll * kThreads
// adjacent vectors, thread t the vectors t, t + kThreads, ... of a tile, so
// that every load instruction of a warp reads 512 contiguous bytes and a
// thread has kUnroll loads of x (and of the residual) in flight before its
// first store. The grid is persistent (at most kCtasPerSm CTAs an SM) and
// strides over the tiles. The bias is copied once a CTA into shared memory
// as f32. A vector's channel group (its index mod C / vector width) is
// kept per slot and advanced by the grid's stride mod C / width, one add
// and one compare a tile, with no division in the loop.
// Bound (H100 SXM): bytes at 3.35 TB/s: x read, the residual read, y written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kCtasPerSm = 8;
constexpr int kMaxC = 12288;  // the bias in 48 KB of shared memory
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float act(float v, bool relu) {
  // A NaN passes, as torch.relu passes it.
  return (relu && v < 0.f) ? 0.f : v;
}

__device__ __forceinline__ uint4 load16(const void* p) { return *reinterpret_cast<const uint4*>(p); }

__device__ __forceinline__ void store16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// One 16-byte vector: 8 bf16 channels starting at bias[8 g].
__device__ __forceinline__ uint4 apply(uint4 xv, const uint4* rv, const float* bias, bool relu, __nv_bfloat16) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(rv);
  const float4 b0 = reinterpret_cast<const float4*>(bias)[0];
  const float4 b1 = reinterpret_cast<const float4*>(bias)[1];
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 v = __bfloat1622float2(x2[j]);
    v.x = __fadd_rn(v.x, b[2 * j]);
    v.y = __fadd_rn(v.y, b[2 * j + 1]);
    if (rv != nullptr) {
      const float2 r = __bfloat1622float2(r2[j]);
      v.x = __fadd_rn(v.x, r.x);
      v.y = __fadd_rn(v.y, r.y);
    }
    o2[j] = __floats2bfloat162_rn(act(v.x, relu), act(v.y, relu));
  }
  return out;
}

// One 16-byte vector: 4 f32 channels starting at bias[4 g].
__device__ __forceinline__ uint4 apply(uint4 xv, const uint4* rv, const float* bias, bool relu, float) {
  const float4 x = *reinterpret_cast<const float4*>(&xv);
  const float4 b = *reinterpret_cast<const float4*>(bias);
  float4 v = make_float4(__fadd_rn(x.x, b.x), __fadd_rn(x.y, b.y), __fadd_rn(x.z, b.z), __fadd_rn(x.w, b.w));
  if (rv != nullptr) {
    const float4 r = *reinterpret_cast<const float4*>(rv);
    v = make_float4(__fadd_rn(v.x, r.x), __fadd_rn(v.y, r.y), __fadd_rn(v.z, r.z), __fadd_rn(v.w, r.w));
  }
  const float4 o = make_float4(act(v.x, relu), act(v.y, relu), act(v.z, relu), act(v.w, relu));
  return *reinterpret_cast<const uint4*>(&o);
}

template <typename T, bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads) k8_conv_epilogue_kernel(const T* x, const T* __restrict__ residual,
                                                                   const float* __restrict__ bias, T* y,
                                                                   long long vectors, int c) {
  constexpr int kWidth = 16 / sizeof(T);  // channels a vector
  extern __shared__ float4 smem_bias[];
  float* sbias = reinterpret_cast<float*>(smem_bias);
  for (int i = threadIdx.x; i < c; i += kThreads) sbias[i] = bias[i];
  __syncthreads();

  const int groups = c / kWidth;
  const long long tile = static_cast<long long>(kUnroll) * kThreads;
  const long long stride = tile * gridDim.x;
  const int step = static_cast<int>(stride % groups);
  long long v0 = static_cast<long long>(blockIdx.x) * tile + threadIdx.x;
  int g[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) g[k] = static_cast<int>((v0 + k * kThreads) % groups);

  for (; v0 < vectors; v0 += stride) {
    uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < vectors) {
        xv[k] = load16(x + v * kWidth);
        if (kResidual) rv[k] = __ldg(reinterpret_cast<const uint4*>(residual + v * kWidth));
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < vectors) {
        store16(y + v * kWidth, apply(xv[k], kResidual ? &rv[k] : nullptr, sbias + g[k] * kWidth, kRelu, T()));
      }
      g[k] += step;
      if (g[k] >= groups) g[k] -= groups;
    }
  }
}

template <typename T>
const void* kernel_for(bool residual, bool relu) {
  if (residual) {
    return relu ? reinterpret_cast<const void*>(&k8_conv_epilogue_kernel<T, true, true>)
                : reinterpret_cast<const void*>(&k8_conv_epilogue_kernel<T, true, false>);
  }
  return relu ? reinterpret_cast<const void*>(&k8_conv_epilogue_kernel<T, false, true>)
              : reinterpret_cast<const void*>(&k8_conv_epilogue_kernel<T, false, false>);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

int sm_count[kMaxDevices];  // filled at a device's first launch; 0 until then

}  // namespace

extern "C" {

// K8 on `stream`: y = act(x + bias (+ residual)) over rows x c elements of
// channels-last x (bf16 where `bf16`, else f32; 16-byte aligned), bias [c]
// f32, residual (null, or as x), y as x (may be x). c a multiple of 8, at
// most 12288. Returns 0 or a cudaError_t.
int sfvos_k8_conv_epilogue(const void* x, const void* bias, const void* residual, void* y, long long rows, int c,
                           int bf16, int relu, void* stream) {
  if (rows < 1 || c < 8 || c % 8 != 0 || c > kMaxC || !aligned16(x) || !aligned16(y) ||
      (residual != nullptr && !aligned16(residual))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[device] == 0) {
    int sms = 0;
    // Not a stream operation: allowed while the stream is captured into a graph.
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[device] = sms;
  }
  const int width = bf16 ? 8 : 4;
  const long long vectors = rows * c / width;
  const long long tiles = (vectors + static_cast<long long>(kUnroll) * kThreads - 1) / (kUnroll * kThreads);
  const long long most = static_cast<long long>(sm_count[device]) * kCtasPerSm;
  const unsigned grid = static_cast<unsigned>(tiles < most ? tiles : most);
  const size_t smem = static_cast<size_t>(c) * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = residual != nullptr;
  const void* kernel = bf16 ? kernel_for<__nv_bfloat16>(res, relu != 0) : kernel_for<float>(res, relu != 0);
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&residual), const_cast<void**>(&bias), &y,
                  const_cast<long long*>(&vectors), &c};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, smem, st);
  return static_cast<int>(err);
}

const char* sfvos_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
