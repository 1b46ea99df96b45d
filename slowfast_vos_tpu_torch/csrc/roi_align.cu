// Multi-scale RoIAlign forward for Hopper (sm_90a), torchvision aligned=False.
//
// Replaces the Pallas TPU kernel `slowfast_vos_tpu/ops/roi_align_pallas.py::_kernel`
// (entry `multiscale_roi_align_pallas`, and its whole-clip form
// `multiscale_roi_align_pallas_clip`). What it computes, per roi r of a
// [T, N] batch (frame = r / N) on its FPN level l (given per roi, computed by
// the caller):
//
//   out[r, ph, pw, c] = 1/4 * sum over the 2x2 samples (iy, ix) of bin
//                       (ph, pw) of bilinear(feat_l[frame], y, x)[c]
//
// with the roi scaled by the level's spatial scale, its width and height
// floored at 1, sample y = y1 + (ph*2 + iy + 0.5) * roi_h / OUT / 2 (x
// alike), samples with y < -1 or y > H (x alike) weighing zero, and in-range
// coordinates clamped to [0, H-1]. This is the exact gather of
// `slowfast_vos_tpu/ops/roi_align.py::multiscale_roi_align`: unlike the TPU
// kernel it samples the level directly, with no patch and no edge clamp.
//
// Bound: a gather with ~32 FLOP per output element; device memory bounds
// it, tensor cores play no part. At DAVIS width one frame's 7x7 pool writes
// 1000x49x256 bf16 (25.1 MB) and reads at most the 43.9 MB P2-P5 pyramid.
//
// Design (simple and correct first): one thread block per (roi, output
// row); threads run along the channel axis, two channels each, so every
// bilinear tap of an NHWC pixel is one coalesced read of the C channels.
// The block reads its own roi box, frame and level, loops over the OUT
// bins of its row, the 2x2 samples and the 4 taps, accumulates in f32 and
// writes the output dtype once. The roi geometry is rounded operation by
// operation (no FMA contraction) so sample coordinates equal those of the
// plain PyTorch version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kSamplingRatio = 2;

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p, int c2) {
    return __ldg(reinterpret_cast<const float2*>(p) + c2);
  }
  static __device__ __forceinline__ void store(float* p, int c2, float2 v) {
    reinterpret_cast<float2*>(p)[c2] = v;
  }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p, int c2) {
    return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p) + c2));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int c2, float2 v) {
    reinterpret_cast<__nv_bfloat162*>(p)[c2] = __float22bfloat162_rn(v);
  }
};

template <typename T>
struct Pyramid {
  const T* feat[4];  // level l: [T, h[l], w[l], C], NHWC contiguous
  int h[4];
  int w[4];
  float scale[4];
};

// One axis of one sample: clamped tap indices, weights and validity.
struct Tap {
  int lo, hi;
  float wlo, whi;
  bool valid;
};

__device__ __forceinline__ Tap make_tap(float start, float step, int idx, int extent) {
  // coord = start + (idx + 0.5) * step, rounded as the plain version does.
  const float coord = __fadd_rn(start, __fmul_rn(static_cast<float>(idx) + 0.5f, step));
  Tap t;
  t.valid = coord >= -1.0f && coord <= static_cast<float>(extent);
  const float c = fminf(fmaxf(coord, 0.0f), static_cast<float>(extent - 1));
  const float c0 = floorf(c);
  t.lo = static_cast<int>(c0);
  t.hi = min(t.lo + 1, extent - 1);
  t.whi = __fsub_rn(c, c0);
  t.wlo = __fsub_rn(1.0f, t.whi);
  return t;
}

template <typename T, int OUT>
__global__ void roi_align_kernel(Pyramid<T> pyr, const float* __restrict__ rois,
                                 const int* __restrict__ levels, int rois_per_frame,
                                 int channels, T* __restrict__ out) {
  const int r = blockIdx.x;
  const int ph = blockIdx.y;
  const int lv = levels[r];
  const int frame = r / rois_per_frame;
  const int h = pyr.h[lv];
  const int w = pyr.w[lv];
  const float scale = pyr.scale[lv];
  const T* base = pyr.feat[lv] + static_cast<size_t>(frame) * h * w * channels;

  const float x1 = __fmul_rn(rois[4 * r + 0], scale);
  const float y1 = __fmul_rn(rois[4 * r + 1], scale);
  const float x2 = __fmul_rn(rois[4 * r + 2], scale);
  const float y2 = __fmul_rn(rois[4 * r + 3], scale);
  const float roi_w = fmaxf(__fsub_rn(x2, x1), 1.0f);
  const float roi_h = fmaxf(__fsub_rn(y2, y1), 1.0f);
  const float step_w = __fdiv_rn(__fdiv_rn(roi_w, static_cast<float>(OUT)),
                                 static_cast<float>(kSamplingRatio));
  const float step_h = __fdiv_rn(__fdiv_rn(roi_h, static_cast<float>(OUT)),
                                 static_cast<float>(kSamplingRatio));

  Tap ty[kSamplingRatio];
#pragma unroll
  for (int iy = 0; iy < kSamplingRatio; ++iy) {
    ty[iy] = make_tap(y1, step_h, ph * kSamplingRatio + iy, h);
  }

  T* out_row = out + (static_cast<size_t>(r) * OUT + ph) * OUT * channels;
  const float inv_count = 1.0f / (kSamplingRatio * kSamplingRatio);
  const int pairs = channels / 2;
  for (int c2 = threadIdx.x; c2 < pairs; c2 += blockDim.x) {
    for (int pw = 0; pw < OUT; ++pw) {
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int ix = 0; ix < kSamplingRatio; ++ix) {
        const Tap tx = make_tap(x1, step_w, pw * kSamplingRatio + ix, w);
#pragma unroll
        for (int iy = 0; iy < kSamplingRatio; ++iy) {
          const Tap& t = ty[iy];
          if (!(t.valid && tx.valid)) continue;
          const float w00 = __fmul_rn(t.wlo, tx.wlo);
          const float w01 = __fmul_rn(t.wlo, tx.whi);
          const float w10 = __fmul_rn(t.whi, tx.wlo);
          const float w11 = __fmul_rn(t.whi, tx.whi);
          const float2 v00 = Pair<T>::load(base + (static_cast<size_t>(t.lo) * w + tx.lo) * channels, c2);
          const float2 v01 = Pair<T>::load(base + (static_cast<size_t>(t.lo) * w + tx.hi) * channels, c2);
          const float2 v10 = Pair<T>::load(base + (static_cast<size_t>(t.hi) * w + tx.lo) * channels, c2);
          const float2 v11 = Pair<T>::load(base + (static_cast<size_t>(t.hi) * w + tx.hi) * channels, c2);
          acc.x += w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x;
          acc.y += w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y;
        }
      }
      acc.x *= inv_count;
      acc.y *= inv_count;
      Pair<T>::store(out_row + static_cast<size_t>(pw) * channels, c2, acc);
    }
  }
}

template <typename T, int OUT>
cudaError_t launch(const void* const feats[4], const int hw[8], const float scales[4],
                   const float* rois, const int* levels, int num_rois, int rois_per_frame,
                   int channels, void* out, cudaStream_t stream) {
  Pyramid<T> pyr;
  for (int l = 0; l < 4; ++l) {
    pyr.feat[l] = static_cast<const T*>(feats[l]);
    pyr.h[l] = hw[2 * l];
    pyr.w[l] = hw[2 * l + 1];
    pyr.scale[l] = scales[l];
  }
  const int pairs = channels / 2;
  const int threads = pairs >= 256 ? 256 : ((pairs + 31) / 32) * 32;
  const dim3 grid(num_rois, OUT);
  roi_align_kernel<T, OUT><<<grid, threads, 0, stream>>>(pyr, rois, levels, rois_per_frame,
                                                         channels, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// feats: 4 pointers to NHWC levels [T, h_l, w_l, C]; rois: [num_rois, 4] f32
// XYXY, frame-major (frame = roi / rois_per_frame); levels: [num_rois] int32
// in 0..3; out: [num_rois, OUT, OUT, C] of the feature dtype. C must be even.
int sfvos_roi_align_forward(const void* f0, const void* f1, const void* f2, const void* f3,
                            int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                            float s0, float s1, float s2, float s3, const void* rois,
                            const void* levels, int num_rois, int rois_per_frame, int channels,
                            int output_size, int is_bf16, void* out, void* stream) {
  const void* feats[4] = {f0, f1, f2, f3};
  const int hw[8] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const float scales[4] = {s0, s1, s2, s3};
  const float* r = static_cast<const float*>(rois);
  const int* lv = static_cast<const int*>(levels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rois <= 0 || rois_per_frame <= 0 || channels <= 0 || channels % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (output_size == 7) {
    err = is_bf16 ? launch<__nv_bfloat16, 7>(feats, hw, scales, r, lv, num_rois, rois_per_frame, channels, out, st)
                  : launch<float, 7>(feats, hw, scales, r, lv, num_rois, rois_per_frame, channels, out, st);
  } else if (output_size == 14) {
    err = is_bf16 ? launch<__nv_bfloat16, 14>(feats, hw, scales, r, lv, num_rois, rois_per_frame, channels, out, st)
                  : launch<float, 14>(feats, hw, scales, r, lv, num_rois, rois_per_frame, channels, out, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* sfvos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
