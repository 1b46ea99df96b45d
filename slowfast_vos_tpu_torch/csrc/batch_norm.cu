// Train-mode BatchNorm for Hopper (sm_90a): K6, its forward and its backward.
//
// Replaces flax `nn.BatchNorm(use_running_average=False, momentum=0.9,
// epsilon=1e-5, dtype=f32)` in SlowFast's train mode
// (`slowfast_vos_tpu/models/slowfast.py:209-214` and `:226-231`, used at
// `:351-362`) and its gradient, which XLA fuses there (there is no Pallas
// kernel for it). The port's plain versions are
// `slowfast_vos_tpu_torch/models/slowfast.py::batch_norm_train` (forward)
// and `batch_norm_train_backward_plain` (the closed-form backward).
//
// Layout: x is a [T, C, H, W] clip in channels-last memory, i.e. N = T*H*W
// rows of C channels, rows contiguous. dy may be a channel slice of a wider
// channels-last tensor (the backward of a `cat` over channels): its rows lie
// `dy_stride` elements apart. dx is written row-contiguous like x.
//
// What it computes, per channel over the N rows, in f32:
//   forward:  mean = sum(x)/N, var = max(sum(x^2)/N - mean^2, 0) (flax's
//             fast variance, biased), invstd = 1/sqrt(var + eps); running =
//             momentum*running + (1 - momentum)*batch, in place;
//             y = cast((x - mean)*(invstd*gamma) + beta), then y = max(y, 0)
//             where the ReLU is fused (on the cast value, as F.relu after it);
//   backward: dy' = dy where y > 0 if the ReLU is fused (y recomputed from x
//             by the forward's arithmetic), else dy; S1 = sum(dy'),
//             S2 = sum(dy' * xhat), xhat = (x - mean)*invstd; dbeta = S1,
//             dgamma = S2, dx = cast((gamma*invstd)*((dy' - S1/N) -
//             xhat*(S2*k/N))), k = 0 where the clamp held var at 0 (its
//             gradient does not pass there), else 1.
// Every elementwise formula replays the plain version's f32 operations in
// their order, each rounded on its own (`__f*_rn`: nvcc contracts nothing
// into an FMA), so that given the same statistics kernel and plain version
// agree bit for bit; the statistics differ from the plain version's only in
// summation order.
//
// Design: each direction is one C call of three kernels.
//  1. reduce: P CTAs; CTA p owns rows [p*R, min((p+1)*R, N)) (R and P from
//     the wrapper, `ops/batch_norm.py::partition`, a function of N alone).
//     A thread owns one 16-byte channel vector (8 bf16 or 4 f32 channels)
//     and every L-th row of the range (L = 256 / (C / vector) row lanes),
//     four rows' loads in flight at once (eight in the backward), and sums
//     in f32 registers in row order; the lanes' sums meet in shared memory and are added in lane
//     order into the CTA's partial, [P, 2, C] in device memory.
//  2. finalize: per channel, 32 thread groups each add every 32nd partial
//     in order, in double, and the 32 group sums are added in order; then
//     the statistics (forward: mean, var, invstd, k and the running update;
//     backward: dgamma, dbeta and the apply's three coefficients).
//  3. normalize (forward) / apply (backward): a CTA per tile of 4 L rows, a
//     thread per 16-byte vector of a row and four rows, all loaded at
//     once, its channels' constants in registers.
// No atomics: every sum has one order for a given (N, C, dtype), so two
// calls, and a CUDA graph's replay, agree bit for bit. Nothing is read back
// to the host; the workspace (partials, coefficients) comes from the
// caller.
//
// Bound: bytes. The forward must read x and write y (2 N C element bytes);
// the two-pass design reads x twice, since the largest calls' x (99 MB at
// P2 [4, 192, 192, 336] bf16) does not stay in the 50 MB L2. The backward
// must read x and dy and write dx (3 passes); this design reads x and dy
// twice (5 passes). The arithmetic, ~10 f32 operations an element, is far
// below the card's rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // reduce, normalize and apply CTAs
constexpr int kMaxC = 1024;         // channels a call takes: C / vector <= kThreads
constexpr int kUnroll = 4;          // rows a thread has in flight
constexpr int kFinChannels = 32;    // finalize CTA: 32 channels x 32 groups of partials
constexpr int kFinGroups = 32;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  using raw = float4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  using raw = uint4;
};

__device__ __forceinline__ void unpack(const float4& q, float (&v)[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

template <typename T>
__device__ __forceinline__ typename Vec<T>::raw load_raw(const T* p) {
  return __ldg(reinterpret_cast<const typename Vec<T>::raw*>(p));
}

// The value of `v` cast to T, as a float.
template <typename T>
__device__ __forceinline__ float cast_to(float v);
template <>
__device__ __forceinline__ float cast_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float cast_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The forward's output element: cast((x - mean)*mul + beta), mul =
// invstd*gamma, then the ReLU where it is fused (NaN passes, as in F.relu).
template <typename T, bool kRelu>
__device__ __forceinline__ float normalized(float x, float mean, float mul, float beta) {
  const float y = cast_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), beta));
  return (kRelu && y < 0.f) ? 0.f : y;
}

struct ReduceArgs {
  const void* x;          // [rows, c]
  const void* dy;         // backward: rows dy_stride elements apart
  long long dy_stride;
  const float* stats;     // backward: [4, c] mean, var, invstd, k
  const float* weight;    // backward with the ReLU: gamma and beta recompute y
  const float* bias;
  float* partials;        // [parts, 2, c]
  long long rows;
  int c;
  int rows_per_part;
};

// Per-channel sums of CTA blockIdx.x's rows: forward (sum x, sum x^2),
// backward (sum dy', sum dy' * xhat).
template <typename T, bool kGrad, bool kRelu>
__global__ void __launch_bounds__(kThreads) bn_reduce_kernel(const ReduceArgs a) {
  constexpr int V = Vec<T>::n;
  // Rows a thread has in flight: the backward's two loads a row (x, dy)
  // gain from eight (measured on an H100), the forward's one from four.
  constexpr int kReduceUnroll = kGrad ? 8 : 4;
  extern __shared__ float lane_sums[];  // [lanes, 2, c]
  const int c = a.c;
  const int vecs = c / V;
  const int lanes = kThreads / vecs;
  const int lane = threadIdx.x / vecs;
  const int c0 = (threadIdx.x % vecs) * V;
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows_per_part;
  const long long r1 = min(r0 + a.rows_per_part, a.rows);
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (lane < lanes) {
    const T* x = static_cast<const T*>(a.x) + c0;
    if constexpr (!kGrad) {
      auto add = [&](const typename Vec<T>::raw& q) {
        float v[V];
        unpack(q, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s1[k] += v[k];
          s2[k] = fmaf(v[k], v[k], s2[k]);
        }
      };
      long long r = r0 + lane;
      for (; r + (kReduceUnroll - 1) * lanes < r1; r += kReduceUnroll * lanes) {
        typename Vec<T>::raw q[kReduceUnroll];
#pragma unroll
        for (int u = 0; u < kReduceUnroll; ++u) q[u] = load_raw(x + (r + u * lanes) * c);
#pragma unroll
        for (int u = 0; u < kReduceUnroll; ++u) add(q[u]);
      }
      for (; r < r1; r += lanes) add(load_raw(x + r * c));
    } else {
      const T* dy = static_cast<const T*>(a.dy) + c0;
      float mean[V], invstd[V], mul[V], beta[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        mean[k] = a.stats[c0 + k];
        invstd[k] = a.stats[2 * c + c0 + k];
        mul[k] = kRelu ? __fmul_rn(invstd[k], a.weight[c0 + k]) : 0.f;
        beta[k] = kRelu ? a.bias[c0 + k] : 0.f;
      }
      auto add = [&](const typename Vec<T>::raw& qx, const typename Vec<T>::raw& qd) {
        float xv[V], dv[V];
        unpack(qx, xv);
        unpack(qd, dv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float d = dv[k];
          if (kRelu && !(normalized<T, false>(xv[k], mean[k], mul[k], beta[k]) > 0.f)) d = 0.f;
          const float xhat = __fmul_rn(__fsub_rn(xv[k], mean[k]), invstd[k]);
          s1[k] += d;
          s2[k] = fmaf(d, xhat, s2[k]);
        }
      };
      long long r = r0 + lane;
      for (; r + (kReduceUnroll - 1) * lanes < r1; r += kReduceUnroll * lanes) {
        typename Vec<T>::raw qx[kReduceUnroll], qd[kReduceUnroll];
#pragma unroll
        for (int u = 0; u < kReduceUnroll; ++u) {
          qx[u] = load_raw(x + (r + u * lanes) * c);
          qd[u] = load_raw(dy + (r + u * lanes) * a.dy_stride);
        }
#pragma unroll
        for (int u = 0; u < kReduceUnroll; ++u) add(qx[u], qd[u]);
      }
      for (; r < r1; r += lanes) add(load_raw(x + r * c), load_raw(dy + r * a.dy_stride));
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      lane_sums[(2 * lane) * c + c0 + k] = s1[k];
      lane_sums[(2 * lane + 1) * c + c0 + k] = s2[k];
    }
  }
  __syncthreads();
  float* out = a.partials + static_cast<long long>(blockIdx.x) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += kThreads) {
    float acc = 0.f;
    for (int l = 0; l < lanes; ++l) acc += lane_sums[2 * l * c + i];
    out[i] = acc;
  }
}

// The two sums of channel blockIdx.x * 32 + threadIdx.x over the partials,
// in double, in a fixed order; true in the one thread (group 0) that holds
// them, for a channel below c.
__device__ __forceinline__ bool partial_sums(const float* partials, int parts, int c, double& s1, double& s2) {
  __shared__ double sums[2][kFinGroups][kFinChannels];
  const int tx = threadIdx.x, g = threadIdx.y;
  const int ch = blockIdx.x * kFinChannels + tx;
  double a = 0.0, b = 0.0;
  if (ch < c) {
    for (int p = g; p < parts; p += kFinGroups) {
      a += partials[(2LL * p) * c + ch];
      b += partials[(2LL * p + 1) * c + ch];
    }
  }
  sums[0][g][tx] = a;
  sums[1][g][tx] = b;
  __syncthreads();
  if (g != 0 || ch >= c) return false;
  s1 = 0.0;
  s2 = 0.0;
  for (int i = 0; i < kFinGroups; ++i) {
    s1 += sums[0][i][tx];
    s2 += sums[1][i][tx];
  }
  return true;
}

struct ForwardFinalizeArgs {
  const float* partials;
  int parts;
  long long rows;
  int c;
  float eps, momentum, one_minus_momentum;
  float* stats;           // [4, c] mean, var, invstd, k
  float* running_mean;    // [c], updated in place
  float* running_var;
};

__global__ void __launch_bounds__(kFinChannels * kFinGroups) bn_finalize_forward_kernel(const ForwardFinalizeArgs a) {
  double s1, s2;
  if (!partial_sums(a.partials, a.parts, a.c, s1, s2)) return;
  const int c = a.c, ch = blockIdx.x * kFinChannels + threadIdx.x;
  const float mean = static_cast<float>(s1 / static_cast<double>(a.rows));
  const float ex2 = static_cast<float>(s2 / static_cast<double>(a.rows));
  const float raw = __fsub_rn(ex2, __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;  // clamp(min=0): NaN passes
  a.stats[ch] = mean;
  a.stats[c + ch] = var;
  a.stats[2 * c + ch] = __frsqrt_rn(__fadd_rn(var, a.eps));
  a.stats[3 * c + ch] = raw >= 0.f ? 1.f : 0.f;  // where clamp's gradient passes
  a.running_mean[ch] = __fadd_rn(__fmul_rn(a.momentum, a.running_mean[ch]), __fmul_rn(a.one_minus_momentum, mean));
  a.running_var[ch] = __fadd_rn(__fmul_rn(a.momentum, a.running_var[ch]), __fmul_rn(a.one_minus_momentum, var));
}

struct BackwardFinalizeArgs {
  const float* partials;
  int parts;
  long long rows;
  int c;
  const float* stats;
  const float* weight;
  float* dweight;   // may be null
  float* dbias;     // may be null
  float* coef;      // [3, c]: gamma*invstd, S1/N, S2*k/N
};

__global__ void __launch_bounds__(kFinChannels * kFinGroups) bn_finalize_backward_kernel(const BackwardFinalizeArgs a) {
  double s1, s2;
  if (!partial_sums(a.partials, a.parts, a.c, s1, s2)) return;
  const int c = a.c, ch = blockIdx.x * kFinChannels + threadIdx.x;
  const float sum_dy = static_cast<float>(s1), sum_dy_xhat = static_cast<float>(s2);
  if (a.dbias != nullptr) a.dbias[ch] = sum_dy;
  if (a.dweight != nullptr) a.dweight[ch] = sum_dy_xhat;
  const float n = static_cast<float>(a.rows);
  a.coef[ch] = __fmul_rn(a.weight[ch], a.stats[2 * c + ch]);
  a.coef[c + ch] = __fdiv_rn(sum_dy, n);
  a.coef[2 * c + ch] = __fdiv_rn(__fmul_rn(sum_dy_xhat, a.stats[3 * c + ch]), n);
}

struct ElementwiseArgs {
  const void* x;          // [rows, c]
  const void* dy;         // apply: rows dy_stride elements apart
  long long dy_stride;
  void* out;              // y or dx, [rows, c]
  const float* stats;
  const float* weight;
  const float* bias;
  const float* coef;      // apply
  long long rows;
  int c;
};

// y = normalized(x) over every row.
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads) bn_normalize_kernel(const ElementwiseArgs a) {
  constexpr int V = Vec<T>::n;
  const int c = a.c, vecs = c / V, lanes = kThreads / vecs;
  const int lane = threadIdx.x / vecs, c0 = (threadIdx.x % vecs) * V;
  if (lane >= lanes) return;
  float mean[V], mul[V], beta[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = a.stats[c0 + k];
    mul[k] = __fmul_rn(a.stats[2 * c + c0 + k], a.weight[c0 + k]);
    beta[k] = a.bias[c0 + k];
  }
  const T* x = static_cast<const T*>(a.x) + c0;
  T* y = static_cast<T*>(a.out) + c0;
  auto emit = [&](long long r, const typename Vec<T>::raw& q) {
    float v[V];
    unpack(q, v);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = normalized<T, kRelu>(v[k], mean[k], mul[k], beta[k]);
    store(y + r * c, v);
  };
  const long long r = static_cast<long long>(blockIdx.x) * kUnroll * lanes + lane;
  typename Vec<T>::raw q[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (r + u * lanes < a.rows) q[u] = load_raw(x + (r + u * lanes) * c);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (r + u * lanes < a.rows) emit(r + u * lanes, q[u]);
  }
}

// dx = cast(coef0 * ((dy' - coef1) - xhat * coef2)) over every row.
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads) bn_apply_kernel(const ElementwiseArgs a) {
  constexpr int V = Vec<T>::n;
  const int c = a.c, vecs = c / V, lanes = kThreads / vecs;
  const int lane = threadIdx.x / vecs, c0 = (threadIdx.x % vecs) * V;
  if (lane >= lanes) return;
  float mean[V], invstd[V], mul[V], beta[V], g[V], m1[V], m2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = a.stats[c0 + k];
    invstd[k] = a.stats[2 * c + c0 + k];
    mul[k] = kRelu ? __fmul_rn(invstd[k], a.weight[c0 + k]) : 0.f;
    beta[k] = kRelu ? a.bias[c0 + k] : 0.f;
    g[k] = a.coef[c0 + k];
    m1[k] = a.coef[c + c0 + k];
    m2[k] = a.coef[2 * c + c0 + k];
  }
  const T* x = static_cast<const T*>(a.x) + c0;
  const T* dy = static_cast<const T*>(a.dy) + c0;
  T* dx = static_cast<T*>(a.out) + c0;
  auto emit = [&](long long r, const typename Vec<T>::raw& qx, const typename Vec<T>::raw& qd) {
    float xv[V], dv[V];
    unpack(qx, xv);
    unpack(qd, dv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float d = dv[k];
      if (kRelu && !(normalized<T, false>(xv[k], mean[k], mul[k], beta[k]) > 0.f)) d = 0.f;
      const float xhat = __fmul_rn(__fsub_rn(xv[k], mean[k]), invstd[k]);
      dv[k] = __fmul_rn(g[k], __fsub_rn(__fsub_rn(d, m1[k]), __fmul_rn(xhat, m2[k])));
    }
    store(dx + r * c, dv);
  };
  const long long r = static_cast<long long>(blockIdx.x) * kUnroll * lanes + lane;
  typename Vec<T>::raw qx[kUnroll], qd[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (r + u * lanes < a.rows) {
      qx[u] = load_raw(x + (r + u * lanes) * c);
      qd[u] = load_raw(dy + (r + u * lanes) * a.dy_stride);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (r + u * lanes < a.rows) emit(r + u * lanes, qx[u], qd[u]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One CTA per kUnroll * lanes rows: each thread loads its kUnroll rows at
// once, with no remainder loop.
long long elementwise_ctas(long long rows, int bf16, int c) {
  const long long tile = kUnroll * (kThreads / (c / (bf16 ? 8 : 4)));
  return (rows + tile - 1) / tile;
}

// What every call checks: a shape the kernels take and 16-byte rows.
bool valid_shape(const void* x, int bf16, long long rows, int c, int rows_per_part, int parts) {
  const int vec = bf16 ? 8 : 4;
  if (rows < 1 || c < vec || c > kMaxC || c % vec != 0 || rows_per_part < 1 || parts < 1) return false;
  if (elementwise_ctas(rows, bf16, c) > INT_MAX) return false;
  if ((rows + rows_per_part - 1) / rows_per_part != parts) return false;
  return aligned16(x);
}

int reduce_smem(int bf16, int c) {
  const int vec = bf16 ? 8 : 4;
  return (kThreads / (c / vec)) * 2 * c * static_cast<int>(sizeof(float));
}

int finalize_ctas(int c) { return (c + kFinChannels - 1) / kFinChannels; }

template <typename T>
cudaError_t launch_forward(const ReduceArgs& r, const ForwardFinalizeArgs& f, const ElementwiseArgs& e, bool relu,
                           int parts, int bf16, cudaStream_t stream) {
  bn_reduce_kernel<T, false, false><<<parts, kThreads, reduce_smem(bf16, r.c), stream>>>(r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finalize_forward_kernel<<<finalize_ctas(r.c), dim3(kFinChannels, kFinGroups), 0, stream>>>(f);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned ctas = static_cast<unsigned>(elementwise_ctas(r.rows, bf16, r.c));
  if (relu) {
    bn_normalize_kernel<T, true><<<ctas, kThreads, 0, stream>>>(e);
  } else {
    bn_normalize_kernel<T, false><<<ctas, kThreads, 0, stream>>>(e);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const ReduceArgs& r, const BackwardFinalizeArgs& f, const ElementwiseArgs& e, bool relu,
                            int parts, int bf16, cudaStream_t stream) {
  const int smem = reduce_smem(bf16, r.c);
  if (relu) {
    bn_reduce_kernel<T, true, true><<<parts, kThreads, smem, stream>>>(r);
  } else {
    bn_reduce_kernel<T, true, false><<<parts, kThreads, smem, stream>>>(r);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finalize_backward_kernel<<<finalize_ctas(r.c), dim3(kFinChannels, kFinGroups), 0, stream>>>(f);
  if ((err = cudaGetLastError()) != cudaSuccess || e.out == nullptr) return err;
  const unsigned ctas = static_cast<unsigned>(elementwise_ctas(r.rows, bf16, r.c));
  if (relu) {
    bn_apply_kernel<T, true><<<ctas, kThreads, 0, stream>>>(e);
  } else {
    bn_apply_kernel<T, false><<<ctas, kThreads, 0, stream>>>(e);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6's forward on `stream`: the statistics of x ([rows, c], f32 or bf16 as
// `bf16` says, rows contiguous, 16-byte aligned) into stats ([4, c] f32:
// mean, var, invstd, k), the running statistics ([c] f32) updated in place,
// and y ([rows, c], x's dtype, 16-byte aligned) normalized, with the ReLU
// where `relu`. weight and bias: [c] f32. partials: parts * 2 * c f32 of
// scratch, parts = ceil(rows / rows_per_part). c a multiple of the 16-byte
// vector (8 bf16, 4 f32), at most 1024. Returns a cudaError_t (0 = ok).
int sfvos_bn_forward(const void* x, int bf16, long long rows, int c, int rows_per_part, int parts,
                     const void* weight, const void* bias, void* running_mean, void* running_var, float eps,
                     float momentum, float one_minus_momentum, int relu, void* y, void* stats, void* partials,
                     void* stream) {
  if (!valid_shape(x, bf16, rows, c, rows_per_part, parts) || !aligned16(y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ReduceArgs r{x, nullptr, 0, nullptr, nullptr, nullptr, static_cast<float*>(partials), rows, c, rows_per_part};
  const ForwardFinalizeArgs f{static_cast<const float*>(partials), parts, rows, c, eps, momentum, one_minus_momentum,
                              static_cast<float*>(stats), static_cast<float*>(running_mean),
                              static_cast<float*>(running_var)};
  const ElementwiseArgs e{x, nullptr, 0, y, static_cast<const float*>(stats), static_cast<const float*>(weight),
                          static_cast<const float*>(bias), nullptr, rows, c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_forward<__nv_bfloat16>(r, f, e, relu != 0, parts, bf16, s)
                               : launch_forward<float>(r, f, e, relu != 0, parts, bf16, s);
  return static_cast<int>(err);
}

// K6's backward on `stream`, from the forward's x and stats: dy (rows
// dy_stride elements apart, x's dtype, 16-byte aligned), the ReLU's mask
// recomputed from x, weight and bias where `relu`. Writes dbias = sum dy'
// and dweight = sum dy' * xhat ([c] f32) where they are not null, and dx
// ([rows, c], x's dtype) where it is not null. partials: parts * 2 * c f32,
// coef: 3 * c f32 of scratch. Returns a cudaError_t (0 = ok).
int sfvos_bn_backward(const void* dy, long long dy_stride, const void* x, int bf16, long long rows, int c,
                      int rows_per_part, int parts, const void* stats, const void* weight, const void* bias,
                      int relu, void* dx, void* dweight, void* dbias, void* partials, void* coef, void* stream) {
  const int vec = bf16 ? 8 : 4;
  if (!valid_shape(x, bf16, rows, c, rows_per_part, parts) || !aligned16(dy) || dy_stride < c ||
      dy_stride % vec != 0 || (dx != nullptr && !aligned16(dx))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ReduceArgs r{x, dy, dy_stride, static_cast<const float*>(stats), static_cast<const float*>(weight),
                     static_cast<const float*>(bias), static_cast<float*>(partials), rows, c, rows_per_part};
  const BackwardFinalizeArgs f{static_cast<const float*>(partials), parts, rows, c, static_cast<const float*>(stats),
                               static_cast<const float*>(weight), static_cast<float*>(dweight),
                               static_cast<float*>(dbias), static_cast<float*>(coef)};
  const ElementwiseArgs e{x, dy, dy_stride, dx, static_cast<const float*>(stats), static_cast<const float*>(weight),
                          static_cast<const float*>(bias), static_cast<const float*>(coef), rows, c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_backward<__nv_bfloat16>(r, f, e, relu != 0, parts, bf16, s)
                               : launch_backward<float>(r, f, e, relu != 0, parts, bf16, s);
  return static_cast<int>(err);
}

const char* sfvos_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
