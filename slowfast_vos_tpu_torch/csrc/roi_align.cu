// Multi-scale RoIAlign for Hopper (sm_90a), torchvision aligned=False: the
// forward (K1, below) and its gradient with respect to the features (K5,
// after it, see its own note).
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
// The pool is separable: out[r, :, :, c] = Wy . F[taps_y, taps_x, c] . Wx^T,
// where taps_y is the ascending list of distinct rows that the roi's valid
// y samples touch (at most 4*OUT), and Wy[ph, i] sums, over the two samples
// of bin ph, the bilinear weight of tap i times 1/2 (x alike; 1/2 * 1/2 is
// the mean over the 2x2 samples). Samples are monotone in their index, so
// the taps of bin ph form one run of at most 4 consecutive entries of
// taps_y. A clamped sample (coordinate in (H-1, H]) has lo == hi: its two
// weights merge into one entry.
//
// Design: one CTA of 256 threads per roi (pool7: its 256 channels in 4
// passes of 64) or per (roi, 32-channel slice) (pool14, so its 80 rois
// still make 640 CTAs), launched roi after roi (frame-major), so the CTAs
// resident at a time read one frame's pyramid (43.9 MB in bf16 at
// 768x1344, under the 50 MB L2).
//   1. Geometry, once per CTA: a warp per axis, a lane per sample
//      (`make_tap`, rounded operation by operation so coordinates equal the
//      plain version's bit for bit). A prefix max and two ballots give each
//      tap its index among the distinct taps (see the kernel); shared
//      memory gets the distinct taps as 32-bit element offsets and each
//      bin's run: its <= 4 offsets and f32 weights.
//   2. Row pass, per slice: threads over (bin ph, distinct column j,
//      16-byte channel vector). Each issues its run's <= 4 16-byte loads at
//      once, so all of a CTA's loads are in flight together, and writes
//      G[ph, j, c] = sum_i Wy[ph, i] * F[y_i, x_j, c] in f32 to shared
//      memory. A row shared by bins ph and ph+1 is loaded by both items.
//   3. Column pass: threads over (ph, pw, channel vector), out = sum over
//      pw's run of Wx[pw, j] * G[ph, j, c], rounded once to the output dtype
//      and stored as one coalesced 16-byte vector (a streaming store: the
//      pyramid, not the output, is what later CTAs read).
// G takes bins x 4*OUT x CS x 4 bytes: 50,176 for pool7 (all 7 bins, CS =
// 64) and for pool14 (7 of its 14 bins at a time, CS = 32), as dynamic
// shared memory (opted into above 48 KB per launch): 4 CTAs fit on an SM.
//
// Bound: a gather with ~32 FLOP per output element, no tensor cores.
// Two byte counts limit it: device memory moves the output (25.1 MB per
// frame at pool7, bf16) and the touched pyramid once; L2 moves each roi's
// own footprint, sum over rois of distinct taps x C x element size, since
// CTAs of overlapping rois do not share what they read.
//
// Departures from the design first planned, with their reasons (bf16 at
// [8, 1000] rois for pool7, [8, 10] for pool14, kernel alone, NVIDIA H100
// 80GB HBM3 at 700 W, `scripts/torch_roi_align_compare.py`):
//  * Rows are not walked bin after bin with the previous run kept in
//    registers (which reads each tap exactly once per thread): that chains
//    each thread's loads over the bins, and it measured 0.84-0.90 ms at
//    pool7, slower than the 0.67 ms of the kernel it replaces; independent
//    (ph, j, v) items measured 0.52 ms. Their second read of a shared row
//    costs no measurable time: bypassing L1 for it changed nothing.
//  * One CTA pools all 4 slices of a pool7 roi in turn, so the geometry is
//    built once per roi: 0.40 ms against 0.48 ms with a CTA per slice.
//  * The geometry is warp-synchronous (scan and ballots) rather than built
//    with block barriers and loops over shared memory: pool7 0.295 ms
//    against 0.316 ms, pool14 0.016 ms against 0.022 ms.
//  * Pool14's G holds 7 bins at a time: 0.0215 ms against 0.0237 ms for 14.
//  * Tile sizes (`Tile` below) are the best of those timed: 32-channel
//    slices, 512 threads and G for fewer bins at pool7 were all slower. A
//    retune edits a copy of this source and times it against this one
//    (`--baseline`).
//  * No TMA: a descriptor's box has a fixed shape, a roi's footprint varies
//    from 1 to 28 taps a side (56 at pool14), and its taps are sparse inside
//    the footprint's bounding box.
//  * No cp.async double buffering: every load of a pass is already in
//    flight at once, straight into registers, and each is used once.
//  * No wgmma: interpolation weights in bf16 or TF32 would break the f32
//    tolerance, and the kernel is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kSamplingRatio = 2;
constexpr int kMaxRun = 4;  // taps of one bin: 2 samples x (lo, hi)

// Tile of each output size: channel slice width (a multiple of 8: 16
// bytes of bf16), slices one CTA pools in turn, threads per CTA, and the
// output rows (bins ph) whose row sums G holds at a time.
template <int OUT>
struct Tile;

template <>
struct Tile<7> {
  static constexpr int kSlice = 64, kPasses = 4, kThreads = 256, kBins = 7;
};

template <>
struct Tile<14> {
  static constexpr int kSlice = 32, kPasses = 1, kThreads = 256, kBins = 7;
};

// 16-byte vectors of feature channels, accumulated in f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  static __device__ __forceinline__ void fma(float (&acc)[4], float w, uint4 v) {
    acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&acc)[4]) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]), __float_as_uint(acc[2]),
                      __float_as_uint(acc[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  static __device__ __forceinline__ void fma(float (&acc)[8], float w, uint4 v) {
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half (little endian)
      acc[2 * i] = fmaf(w, __uint_as_float(words[i] << 16), acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, __uint_as_float(words[i] & 0xffff0000u), acc[2 * i + 1]);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&acc)[8]) {
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      memcpy(&words[i], &p, sizeof(uint32_t));
    }
    return make_uint4(words[0], words[1], words[2], words[3]);
  }
};

// a[l] with constant indices only: a dynamic index would copy the kernel
// parameter to local memory.
template <typename X>
__device__ __forceinline__ X pick(const X (&a)[4], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

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

// Separable tables of one axis of one roi.
template <int OUT>
struct Axis {
  static constexpr int kSamples = OUT * kSamplingRatio;
  static constexpr int kCand = 2 * kSamples;  // (lo, hi) per sample; also the most distinct taps
  // The distinct taps of the valid samples, ascending, as element offsets
  // in the frame's level (a row tap times w x C, a column tap times C).
  int off[kCand];
  int count;          // distinct taps
  int start[OUT], len[OUT];  // run of bin b: distinct taps start[b] .. start[b] + len[b] - 1
  alignas(16) int run_off[OUT][kMaxRun];  // off[start[b] + k], padded with off[start[b]]
  alignas(16) float wt[OUT][kMaxRun];     // weight of each run entry, 0 past len[b]
};

// Builds the tables of axis a (0: y, 1: x) of roi r, one warp, lane s
// taking sample s; the forward and backward kernels share it, so both see
// the same taps and weights. Valid samples' taps are nondecreasing (lo_s <=
// hi_s <= lo_s + 1, both monotone in s), so a candidate tap is new exactly
// where it exceeds the largest tap before it, and new taps come in
// ascending order: a tap's index among the distinct taps is the count of
// new ones up to its position, less one, less one more where a larger tap
// came before it (only lo_s can follow a larger tap, hi_{s-1} = lo_s + 1).
// `stride` is the element offset of one tap: w x C for rows, C for columns.
template <int OUT>
__device__ __forceinline__ void build_axis(Axis<OUT>& ax, int a, int lane, const float* __restrict__ rois, int r,
                                           float scale, int extent_px, int stride) {
  constexpr int kS = Axis<OUT>::kSamples;
  static_assert(kS <= 32, "a lane per sample");
  Tap t = {0, 0, 0.0f, 0.0f, false};
  if (lane < kS) {
    const float lo_corner = __fmul_rn(rois[4 * r + 1 - a], scale);   // y1 or x1
    const float hi_corner = __fmul_rn(rois[4 * r + 3 - a], scale);   // y2 or x2
    const float extent = fmaxf(__fsub_rn(hi_corner, lo_corner), 1.0f);
    const float step = __fdiv_rn(__fdiv_rn(extent, static_cast<float>(OUT)),
                                 static_cast<float>(kSamplingRatio));
    t = make_tap(lo_corner, step, lane, extent_px);
  }
  constexpr unsigned kAll = 0xffffffffu;
  int before = t.valid ? t.hi : -1;  // inclusive prefix max of valid hi taps
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(kAll, before, d);
    if (lane >= d) before = max(before, o);
  }
  before = __shfl_up_sync(kAll, before, 1);  // exclusive: the largest tap before lo_s
  if (lane == 0) before = -1;
  const bool new_lo = t.valid && t.lo > before;
  const bool new_hi = t.valid && t.hi > t.lo && t.hi > before;
  const unsigned lo_bits = __ballot_sync(kAll, new_lo);
  const unsigned hi_bits = __ballot_sync(kAll, new_hi);
  const unsigned upto = kAll >> (31 - lane);  // lanes 0..lane
  const int rank_hi = __popc(lo_bits & upto) + __popc(hi_bits & upto) - 1;
  const int rank_lo = rank_hi - (new_hi ? 1 : 0) - (before > t.lo ? 1 : 0);
  if (new_lo) ax.off[rank_lo] = t.lo * stride;
  if (new_hi) ax.off[rank_hi] = t.hi * stride;
  if (lane == 0) ax.count = __popc(lo_bits) + __popc(hi_bits);
  __syncwarp();
  // Runs: lane b takes bin b, whose samples are 2b and 2b + 1.
  const int s0 = kSamplingRatio * lane;
  const bool v0 = __shfl_sync(kAll, t.valid, s0 % 32);
  const bool v1 = __shfl_sync(kAll, t.valid, (s0 + 1) % 32);
  const int lo0 = __shfl_sync(kAll, rank_lo, s0 % 32);
  const int hi0 = __shfl_sync(kAll, rank_hi, s0 % 32);
  const int lo1 = __shfl_sync(kAll, rank_lo, (s0 + 1) % 32);
  const int hi1 = __shfl_sync(kAll, rank_hi, (s0 + 1) % 32);
  const float wlo0 = __shfl_sync(kAll, 0.5f * t.wlo, s0 % 32);
  const float whi0 = __shfl_sync(kAll, 0.5f * t.whi, s0 % 32);
  const float wlo1 = __shfl_sync(kAll, 0.5f * t.wlo, (s0 + 1) % 32);
  const float whi1 = __shfl_sync(kAll, 0.5f * t.whi, (s0 + 1) % 32);
  if (lane < OUT) {
    float* wt = ax.wt[lane];
#pragma unroll
    for (int k = 0; k < kMaxRun; ++k) wt[k] = 0.0f;
    const int start = v0 ? lo0 : v1 ? lo1 : 0;
    const int len = v0 || v1 ? (v1 ? hi1 : hi0) + 1 - start : 0;
    if (v0) {
      wt[lo0 - start] += wlo0;
      wt[hi0 - start] += whi0;
    }
    if (v1) {
      wt[lo1 - start] += wlo1;
      wt[hi1 - start] += whi1;
    }
    ax.start[lane] = start;
    ax.len[lane] = len;
#pragma unroll
    for (int k = 0; k < kMaxRun; ++k) ax.run_off[lane][k] = ax.off[start + (k < len ? k : 0)];
  }
}

template <typename T, int OUT>
__global__ void __launch_bounds__(Tile<OUT>::kThreads)
    roi_align_kernel(Pyramid<T> pyr, const float* __restrict__ rois, const int* __restrict__ levels,
                     int rois_per_frame, int channels, int ctas_per_roi, T* __restrict__ out) {
  constexpr int CS = Tile<OUT>::kSlice;
  constexpr int kPasses = Tile<OUT>::kPasses;
  constexpr int kThreads = Tile<OUT>::kThreads;
  constexpr int kBins = Tile<OUT>::kBins;
  constexpr int kSteps = (OUT + kBins - 1) / kBins;  // G fills per slice
  constexpr int kVec = Vec<T>::kWidth;
  constexpr int kSliceVecs = CS / kVec;  // 16-byte vectors in a full slice
  constexpr int kPlanes = kVec / 4;      // float4 planes of one f32 vector in G
  constexpr int kCand = Axis<OUT>::kCand;
  static_assert(CS % kVec == 0, "a slice is whole 16-byte vectors");
  static_assert(kThreads >= 64, "a warp per axis");

  __shared__ Axis<OUT> axes[2];  // 0: y, 1: x
  // G[ph][j][plane][v]: f32 row sums, float4 planes so that neighbouring
  // threads (neighbouring v) touch neighbouring 16 bytes.
  extern __shared__ float4 g[];

  const int r = blockIdx.x / ctas_per_roi;
  const int c_begin = (blockIdx.x % ctas_per_roi) * CS * kPasses;
  const int lv = levels[r];
  const int frame = r / rois_per_frame;
  const int h = pick(pyr.h, lv);
  const int w = pick(pyr.w, lv);
  const float scale = pick(pyr.scale, lv);
  const T* level = pick(pyr.feat, lv) + static_cast<size_t>(frame) * h * w * channels;
  const int tid = threadIdx.x;

  // 1. Geometry: warp a builds axis a.
  if (tid < 64) {
    const int a = tid / 32;
    build_axis<OUT>(axes[a], a, tid % 32, rois, r, scale, a == 0 ? h : w, a == 0 ? w * channels : channels);
  }
  __syncthreads();

  const Axis<OUT>& ay = axes[0];
  const Axis<OUT>& ax = axes[1];
  constexpr int kNdx = kCand;
  for (int step = 0; step < kPasses * kSteps; ++step) {
    const int pass = step / kSteps;
    const int ph0 = step % kSteps * kBins;
    const int bins = min(kBins, OUT - ph0);
    const int c0 = c_begin + pass * CS;
    if (c0 >= channels) break;
    const int nv = min(CS, channels - c0) / kVec;
    const T* base = level + c0;
    // 2. Row pass: G[ph, j, :] = sum over ph's run of Wy * F[y_i, x_j, :].
    // Items are (bin ph, column j, vector v), v fastest and ph slowest: each
    // item issues its run's <= 4 loads at once, so a CTA's loads are in
    // flight together. ph = row / count by a float reciprocal: exact, since
    // (row + 1/2) / count is at least 1/(2 count) from an integer.
    const int count = ax.count;
    const float inv_count = 1.0f / static_cast<float>(max(count, 1));
#pragma unroll 2
    for (int item = tid; item < bins * count * kSliceVecs; item += kThreads) {
      const int v = item % kSliceVecs;
      const int row = item / kSliceVecs;
      const int gph = __float2int_rz((static_cast<float>(row) + 0.5f) * inv_count);
      const int j = row - gph * count;
      const int ph = ph0 + gph;
      if (v >= nv) continue;
      const T* col = base + (ax.off[j] + v * kVec);
      const int l = ay.len[ph];
      const int4 ro = *reinterpret_cast<const int4*>(ay.run_off[ph]);
      const float4 wt = *reinterpret_cast<const float4*>(ay.wt[ph]);
      const int offs[kMaxRun] = {ro.x, ro.y, ro.z, ro.w};
      const float wts[kMaxRun] = {wt.x, wt.y, wt.z, wt.w};
      uint4 rows[kMaxRun];
#pragma unroll
      for (int k = 0; k < kMaxRun; ++k) {
        if (k < l) rows[k] = __ldg(reinterpret_cast<const uint4*>(col + offs[k]));
      }
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxRun; ++k) {
        if (k < l) Vec<T>::fma(acc, wts[k], rows[k]);
      }
      float4* gp = g + (gph * kNdx + j) * kPlanes * kSliceVecs + v;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        gp[p * kSliceVecs] = make_float4(acc[4 * p], acc[4 * p + 1], acc[4 * p + 2], acc[4 * p + 3]);
      }
    }
    __syncthreads();

    // 3. Column pass: out[ph, pw, :] = sum over pw's run of Wx * G[ph, j, :].
    T* out_r = out + static_cast<size_t>(r) * OUT * OUT * channels + c0;
    for (int item = tid; item < bins * OUT * kSliceVecs; item += kThreads) {
      const int v = item % kSliceVecs;
      const int gbin = item / kSliceVecs;
      if (v >= nv) continue;
      const int gph = gbin / OUT;
      const int pw = gbin % OUT;
      const int bin = ph0 * OUT + gbin;
      const int s = ax.start[pw];
      const int l = ax.len[pw];
      const float4 wt = *reinterpret_cast<const float4*>(ax.wt[pw]);
      const float wts[kMaxRun] = {wt.x, wt.y, wt.z, wt.w};
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxRun; ++k) {
        if (k < l) {
          const float4* gp = g + (gph * kNdx + s + k) * kPlanes * kSliceVecs + v;
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) {
            const float4 q = gp[p * kSliceVecs];
            acc[4 * p] = fmaf(wts[k], q.x, acc[4 * p]);
            acc[4 * p + 1] = fmaf(wts[k], q.y, acc[4 * p + 1]);
            acc[4 * p + 2] = fmaf(wts[k], q.z, acc[4 * p + 2]);
            acc[4 * p + 3] = fmaf(wts[k], q.w, acc[4 * p + 3]);
          }
        }
      }
      // Streaming store: the output is not read again here, the pyramid is.
      __stcs(reinterpret_cast<uint4*>(out_r + static_cast<size_t>(bin) * channels + v * kVec), Vec<T>::pack(acc));
    }
    __syncthreads();  // G is rewritten by the next step
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
  using Tl = Tile<OUT>;
  constexpr size_t smem = static_cast<size_t>(Tl::kBins) * Axis<OUT>::kCand * Tl::kSlice * sizeof(float);
  auto kernel = roi_align_kernel<T, OUT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kCtaChannels = Tl::kSlice * Tl::kPasses;
  const int ctas_per_roi = (channels + kCtaChannels - 1) / kCtaChannels;
  kernel<<<num_rois * ctas_per_roi, Tl::kThreads, smem, stream>>>(pyr, rois, levels, rois_per_frame, channels,
                                                                  ctas_per_roi, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(int output_size, const void* const feats[4], const int hw[8], const float scales[4],
                       const float* rois, const int* levels, int num_rois, int rois_per_frame, int channels,
                       void* out, cudaStream_t stream) {
  if (output_size == 7) {
    return launch<T, 7>(feats, hw, scales, rois, levels, num_rois, rois_per_frame, channels, out, stream);
  }
  if (output_size == 14) {
    return launch<T, 14>(feats, hw, scales, rois, levels, num_rois, rois_per_frame, channels, out, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward (K5): the gradient of the pool with respect to the features.
//
// Replaces the JAX package's custom VJP `slowfast_vos_tpu/ops/roi_align_mm.py
// ::_msra_mmgrad_bwd`, which XLA computes as dense separable matmuls (no
// Pallas kernel): per level, grad = sum over the level's rois of
// A_y^T . g . A_x, with [rois, H_l, 7, C] temporaries. Here, with the
// forward's tables (`build_axis`, the same rounding and the level passed in):
//
//   grad_l[f, y_i, x_j, c] = sum over the rois r of frame f on level l, in
//       ascending r, of sum_{ph, pw} Wy_r[ph, i] Wx_r[pw, j] g[r, ph, pw, c]
//
// over each roi's distinct taps i (rows) and j (columns): the transpose of
// the forward's map, so a sample outside [-1, H] adds nothing and a pixel
// that no roi samples gets 0.
//
// Design: the owner of a gradient tile gathers what lands in it.
//   1. Geometry, once per roi (`roi_geometry_kernel`, a warp pair per roi):
//      both axes by `build_axis` with pixel indices (stride 1), written to
//      a scratch record (`BwdAxis`: 368 bytes an axis at pool7, 736 at
//      pool14) with each distinct tap's inverse run (the first and last bin
//      whose run holds it; runs are contiguous and monotone, so the bins of
//      a tap are contiguous), and the roi's footprint box (first and last
//      distinct row and column; empty without a valid sample).
//   2. Gather (`roi_align_backward_kernel`), one CTA per (frame, level,
//      16x16-pixel tile, 32-channel slice). It scans its frame's rois in
//      ascending index, 256 at a time, lists in order (ballot and prefix
//      count) those on its level whose box meets the tile, and counts each
//      listed roi's distinct rows and columns inside the tile (a warp per
//      roi, ballots over its taps). Then, roi after roi:
//        - column pass, over (bin ph whose run touches the tile's rows,
//          distinct column j inside the tile, 8-channel item):
//          H[ph, j, c] = sum over the bins pw of tap j of Wx[pw, j] g[r, ph, pw, c],
//          f32 in shared memory;
//        - row pass, over (distinct row i inside the tile, j, item): adds
//          the sum over the bins ph of tap i of Wy[ph, i] H[ph, j, c] into
//          the CTA's f32 accumulator tile in shared memory. Within one roi
//          distinct (i, j) are distinct pixels, so a plain read-modify-write
//          suffices; a barrier separates rois.
//      While roi e's passes run, roi e + 1's record and g slice are on
//      their way into the other shared-memory buffer (cp.async), so a roi
//      costs two barriers and no load from L2 on its chain. Last, the CTA
//      writes its tile once with 16-byte stores, rounded once to bf16 (or
//      kept f32); a tile that no roi touches writes zeros.
//
// Bound. Bytes bound the function: it reads g and writes the dense
// gradient pyramid once (88 MB in bf16 for 2 frames of the 768x1344 canvas
// at 256 channels, 0.034 ms at 3.35 TB/s); the kernel adds the roi records
// (1-3 KB a roi) and, through L2, each roi's g slice once per tile and slice
// its footprint meets. It does not run at that bound: the walk is serial
// per CTA and the tiles under many rois (45-76 rois on one P4 tile for the
// synthetic rois, both objects' positives in training) set its time. Timed
// with a part cut out (pool7 [2, 512] synthetic / train-path rois, in the
// setting of the departures below): no roi walked 0.040 / 0.040 ms, the walk's
// skeleton (copies, counts, barriers) 0.137 / 0.098, plus the column pass
// 0.187 / 0.117, plus the row pass (all) 0.293 / 0.146; without the g copy
// 0.262 / 0.130. The row pass's shared-memory read-modify-write and the
// per-roi latency of the skeleton take most of it. No global atomics and
// no f32 pyramid, and every pixel sums its contributions in one fixed
// order, so results repeat bit for bit.
//
// Departures from the design first planned, with their times (bf16, 256
// channels, kernel alone with the levels given, NVIDIA H100 80GB HBM3 at
// 700 W, `scripts/torch_roi_align_compare.py`; pool7 [2, 512] and pool14
// [2, 128], synthetic / train-path rois; the atomic kernel this replaces:
// 0.786 / 0.527 and 0.454 / 0.308 ms):
//  * The first form read g from L2 in the column pass and counted a roi's
//    taps inside the tile while staging it, with 64-channel slices at
//    pool7: 0.434 / 0.232 and 0.178 / 0.131 ms. Copying the next roi's
//    record and g slice with cp.async and counting taps per chunk took the
//    L2 latency off each roi's chain: 0.364 / 0.136 and 0.174 / 0.090.
//  * 32-channel slices at pool7 (more CTAs under a hot spot): 0.319 /
//    0.138 against 0.364 / 0.136 with 64. 16-channel slices: 0.337 / 0.178
//    and 0.146 / 0.090 (8-channel items).
//  * 8-channel work items (one chain of shared-memory loads serves 8
//    channels): 0.293 / 0.146 and 0.157 / 0.089, against 0.318 / 0.138 and
//    0.174 / 0.090 with 4.
//  * 16x16 tiles: 8x16 walked more rois per roi's footprint, 0.296 / 0.149
//    and 0.187 / 0.104; 512 threads, 0.343 / 0.173 and 0.160 / 0.096;
//    128 threads (first form) 0.703 / 0.307 at pool7. Unrolling the item
//    loops by 2 changed nothing (0.295 / 0.145).
//  * Prefetching two rois ahead (three buffers): 0.294 / 0.147 and 0.159 /
//    0.090; odd rows and pixels taking an item's second float4 first (no
//    2-way bank conflict): 0.299 / 0.153 and 0.159 / 0.091; against 0.292 /
//    0.146 and 0.158 / 0.089 for this form in the same call. Both lost.
//  * No split of a hot tile's roi list over several CTAs with f32 partial
//    tiles: placing the partials without a global counter needs a count
//    and prefix pass of its own; untried.
//  * No TMA or wgmma: a roi's footprint and taps vary in shape, and the
//    weights must stay f32 for the f32 tolerance.

// Gather tile of each output size: pixel rows and columns, channel slice,
// channels per work item (4 or 8: one thread's chain of shared-memory
// loads serves them all), threads per CTA.
template <int OUT>
struct BwdTile;

template <>
struct BwdTile<7> {
  static constexpr int kRows = 16, kCols = 16, kSlice = 32, kItem = 8, kThreads = 256;
};

template <>
struct BwdTile<14> {
  static constexpr int kRows = 16, kCols = 16, kSlice = 32, kItem = 8, kThreads = 256;
};

// One axis of one roi as the gather reads it (scratch memory).
template <int OUT>
struct alignas(16) BwdAxis {
  static constexpr int kCand = Axis<OUT>::kCand;
  int tap[kCand];           // distinct taps (pixel indices), ascending; INT_MAX past `count`
  int span[kCand];          // bins whose runs hold tap i: first | last << 16
  int start[OUT];           // bin b's run: distinct taps start[b] ..
  float wt[OUT][kMaxRun];   // .. with these weights (0 past the run)
  int count;                // distinct taps
};

template <int OUT>
struct BwdRoi {
  BwdAxis<OUT> axis[2];  // 0: y, 1: x
};

template <int OUT>
size_t backward_scratch_bytes(int num_rois) {
  return static_cast<size_t>(num_rois) * (sizeof(BwdRoi<OUT>) + sizeof(int4));
}

template <typename T>
struct GradPyramid {
  T* grad[4];  // level l: [T, h[l], w[l], C], NHWC contiguous, written whole
  int h[4];
  int w[4];
  float scale[4];
  int tiles_x[4];   // tile columns of level l
  int tile_end[4];  // tiles of levels 0..l of one frame
};

constexpr int kGeomRois = 4;  // rois per CTA of the geometry kernel

// Writes recs[r] and boxes[r] = (first row, last row, first column, last
// column) of roi r's distinct taps, or (1, 0, 1, 0) where it has none.
template <typename T, int OUT>
__global__ void __launch_bounds__(64 * kGeomRois)
    roi_geometry_kernel(GradPyramid<T> pyr, const float* __restrict__ rois, const int* __restrict__ levels,
                        int num_rois, BwdRoi<OUT>* __restrict__ recs, int4* __restrict__ boxes) {
  constexpr int kCand = Axis<OUT>::kCand;
  __shared__ Axis<OUT> axes[kGeomRois][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / 2, a = warp % 2;
  const int r = blockIdx.x * kGeomRois + slot;
  Axis<OUT>& ax = axes[slot][a];
  if (r < num_rois) {  // warp-uniform
    const int lv = levels[r];
    build_axis<OUT>(ax, a, lane, rois, r, pick(pyr.scale, lv), a == 0 ? pick(pyr.h, lv) : pick(pyr.w, lv), 1);
    __syncwarp();
    BwdAxis<OUT>& out = recs[r].axis[a];
    for (int i = lane; i < kCand; i += 32) {
      int first = OUT, last = -1;
      for (int b = 0; b < OUT; ++b) {
        if (ax.start[b] <= i && i < ax.start[b] + ax.len[b]) {
          first = min(first, b);
          last = b;
        }
      }
      const bool on = i < ax.count;
      out.tap[i] = on ? ax.off[i] : INT_MAX;
      out.span[i] = on ? first | last << 16 : 0;
    }
    if (lane < OUT) {
      out.start[lane] = ax.start[lane];
#pragma unroll
      for (int k = 0; k < kMaxRun; ++k) out.wt[lane][k] = ax.wt[lane][k];
    }
    if (lane == 0) out.count = ax.count;
  }
  __syncthreads();
  if (r < num_rois && a == 0 && lane == 0) {
    const Axis<OUT>& ay = axes[slot][0];
    const Axis<OUT>& ax2 = axes[slot][1];
    boxes[r] = ay.count > 0 && ax2.count > 0
                   ? make_int4(ay.off[0], ay.off[ay.count - 1], ax2.off[0], ax2.off[ax2.count - 1])
                   : make_int4(1, 0, 1, 0);
  }
}

// 4 * kF4 channels of g as f32, from shared memory.
template <int kF4>
__device__ __forceinline__ void smem_item(const float* p, float4 (&v)[kF4]) {
#pragma unroll
  for (int u = 0; u < kF4; ++u) v[u] = reinterpret_cast<const float4*>(p)[u];
}

__device__ __forceinline__ float4 bf16x4(unsigned lo, unsigned hi) {
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u), __uint_as_float(hi << 16),
                     __uint_as_float(hi & 0xffff0000u));
}

template <int kF4>
__device__ __forceinline__ void smem_item(const __nv_bfloat16* p, float4 (&v)[kF4]) {
  if constexpr (kF4 % 2 == 0) {
#pragma unroll
    for (int u = 0; u < kF4 / 2; ++u) {
      const uint4 b = reinterpret_cast<const uint4*>(p)[u];
      v[2 * u] = bf16x4(b.x, b.y);
      v[2 * u + 1] = bf16x4(b.z, b.w);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kF4; ++u) {
      const uint2 b = reinterpret_cast<const uint2*>(p)[u];
      v[u] = bf16x4(b.x, b.y);
    }
  }
}

__device__ __forceinline__ void fma4(float4& s, float w, float4 v) {
  s.x = fmaf(w, v.x, s.x);
  s.y = fmaf(w, v.y, s.y);
  s.z = fmaf(w, v.z, s.z);
  s.w = fmaf(w, v.w, s.w);
}

// Dynamic shared memory of the gather: the f32 tile, one roi's column
// sums, and two buffers of a roi's g slice in g's dtype.
template <typename T, int OUT>
constexpr size_t backward_smem_bytes() {
  using Tl = BwdTile<OUT>;
  return static_cast<size_t>(Tl::kRows + OUT) * Tl::kCols * Tl::kSlice * sizeof(float) +
         2 * static_cast<size_t>(OUT) * OUT * Tl::kSlice * sizeof(T);
}

template <typename T, int OUT>
__global__ void __launch_bounds__(BwdTile<OUT>::kThreads)
    roi_align_backward_kernel(GradPyramid<T> pyr, const T* __restrict__ g, const int* __restrict__ levels,
                              const BwdRoi<OUT>* __restrict__ recs, const int4* __restrict__ boxes,
                              int rois_per_frame, int channels, int slices) {
  using Tl = BwdTile<OUT>;
  constexpr int TY = Tl::kRows, TX = Tl::kCols, CS = Tl::kSlice, kThreads = Tl::kThreads;
  constexpr int kQ = CS / 4;             // float4s of a pixel's slice in the f32 tiles
  constexpr int kItem = Tl::kItem;       // channels per work item
  constexpr int kF4 = kItem / 4;         // float4s per work item
  constexpr int kV = CS / kItem;         // work items per pixel (or per column sum)
  constexpr int kWarps = kThreads / 32;
  constexpr int kCand = Axis<OUT>::kCand;
  constexpr int kBins = OUT * OUT;
  constexpr int kRecVecs = static_cast<int>(sizeof(BwdRoi<OUT>) / sizeof(int4));
  constexpr int kElem16 = 16 / static_cast<int>(sizeof(T));  // elements of g in 16 bytes
  constexpr unsigned kAll = 0xffffffffu;
  static_assert(CS % 8 == 0 && CS % kItem == 0 && kItem % 4 == 0 && kThreads % 32 == 0, "whole vectors, whole warps");
  static_assert(sizeof(BwdRoi<OUT>) % sizeof(int4) == 0, "records copy as 16-byte vectors");

  __shared__ BwdRoi<OUT> tab[2];    // records of the current and the next listed roi
  __shared__ int4 rng[kThreads];    // per listed roi: its distinct taps inside the tile, rows ia..ib-1, columns ja..jb-1
  __shared__ int list[kThreads];    // listed rois of one scanned chunk, ascending
  __shared__ int warp_count[kWarps];
  extern __shared__ float4 smem[];
  float4* acc = smem;                  // [TY * TX][kQ]: the gradient tile in f32
  float4* hsum = smem + TY * TX * kQ;  // [<= OUT * TX][kQ]: one roi's column sums
  T* gbuf = reinterpret_cast<T*>(hsum + OUT * TX * kQ);  // [2][OUT * OUT][CS]: g slices

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // CTAs are frame-major, then level, tile (row-major), channel slice.
  const int slice = blockIdx.x % slices;
  const int tile_all = blockIdx.x / slices;
  const int frame = tile_all / pyr.tile_end[3];
  int t = tile_all - frame * pyr.tile_end[3];
  const int lv = (t >= pyr.tile_end[0]) + (t >= pyr.tile_end[1]) + (t >= pyr.tile_end[2]);
  t -= lv > 0 ? pick(pyr.tile_end, lv - 1) : 0;
  const int h = pick(pyr.h, lv);
  const int w = pick(pyr.w, lv);
  const int tiles_x = pick(pyr.tiles_x, lv);
  const int y0 = t / tiles_x * TY;
  const int x0 = t % tiles_x * TX;
  const int c0 = slice * CS;
  const int nc = min(CS, channels - c0);
  const int nvi = (nc + kItem - 1) / kItem;  // items that hold a channel (past nc: ignored, never stored)
  const int nv16 = nc / kElem16;  // 16-byte vectors of a bin's slice

  for (int i = tid; i < TY * TX * kQ; i += kThreads) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // Starts the asynchronous copy of listed roi e's record and g slice into
  // buffer `buf`; `__pipeline_wait_prior(0)` by every thread, then a
  // barrier, make them visible.
  auto prefetch = [&](int e, int buf) {
    const int r = list[e];
    const int4* src = reinterpret_cast<const int4*>(recs + r);
    int4* dst = reinterpret_cast<int4*>(tab + buf);
    for (int v = tid; v < kRecVecs; v += kThreads) __pipeline_memcpy_async(dst + v, src + v, sizeof(int4));
    const T* g_r = g + static_cast<size_t>(r) * kBins * channels + c0;
    T* gb = gbuf + buf * kBins * CS;
    for (int v = tid; v < kBins * nv16; v += kThreads) {
      const int bin = v / nv16, u = v - bin * nv16;
      __pipeline_memcpy_async(gb + bin * CS + u * kElem16, g_r + bin * channels + u * kElem16, 16);
    }
    __pipeline_commit();
  };

  for (int chunk = 0; chunk < rois_per_frame; chunk += kThreads) {
    // 1. The chunk's rois on this level whose footprint box meets the tile.
    const int k = chunk + tid;
    bool keep = false;
    if (k < rois_per_frame) {
      const int r = frame * rois_per_frame + k;
      const int4 bx = boxes[r];
      keep = levels[r] == lv && bx.x <= bx.y && bx.x < y0 + TY && bx.y >= y0 && bx.z < x0 + TX && bx.w >= x0;
    }
    const unsigned bits = __ballot_sync(kAll, keep);
    if (lane == 0) warp_count[warp] = __popc(bits);
    __syncthreads();  // also ends the previous chunk's use of list, rng and the buffers
    int pos = __popc(bits & ((1u << lane) - 1u)), n = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      pos += v < warp ? warp_count[v] : 0;
      n += warp_count[v];
    }
    if (keep) list[pos] = frame * rois_per_frame + k;
    __syncthreads();
    if (n > 0) prefetch(0, 0);
    // Each listed roi's distinct taps inside the tile, a warp per roi:
    // ballots count the taps before the tile and before its end.
    for (int e = warp; e < n; e += kWarps) {
      int cnt[4] = {0, 0, 0, 0};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int* taps = recs[list[e]].axis[a].tap;
        const int lo = a == 0 ? y0 : x0;
        const int hi = lo + (a == 0 ? TY : TX);
#pragma unroll
        for (int i0 = 0; i0 < kCand; i0 += 32) {
          const int tap = i0 + lane < kCand ? __ldg(taps + i0 + lane) : INT_MAX;
          cnt[2 * a] += __popc(__ballot_sync(kAll, tap < lo));
          cnt[2 * a + 1] += __popc(__ballot_sync(kAll, tap < hi));
        }
      }
      if (lane == 0) rng[e] = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
    }

    // 2. Roi after roi, in the listed order; roi e + 1's copy runs under
    // roi e's passes.
    for (int e = 0; e < n; ++e) {
      const int buf = e & 1;
      __pipeline_wait_prior(0);
      __syncthreads();  // roi e's buffers and the ranges in place; the previous row pass done
      if (e + 1 < n) prefetch(e + 1, buf ^ 1);
      const BwdAxis<OUT>& ay = tab[buf].axis[0];
      const BwdAxis<OUT>& ax = tab[buf].axis[1];
      const int4 rg = rng[e];
      const int ia = rg.x, ib = rg.y, ja = rg.z;
      const int nj = rg.w - ja;
      const bool hit = ia < ib && nj > 0;
      const int ph_lo = hit ? ay.span[ia] & 0xffff : 0;
      const float inv_nj = 1.0f / static_cast<float>(max(nj, 1));
      if (hit) {
        // Column pass: H[ph, j, q] = sum over the bins pw of tap j of Wx * g.
        // Items (row = (ph - ph_lo) * nj + j - ja, quad), quad fastest;
        // row / nj by a float reciprocal, exact as in the forward.
        const int nph = (ay.span[ib - 1] >> 16) + 1 - ph_lo;
        const T* gb = gbuf + buf * kBins * CS + ph_lo * OUT * CS;
        for (int item = tid; item < nph * nj * kV; item += kThreads) {
          const int v = item % kV;
          const int row = item / kV;
          if (v >= nvi) continue;
          const int dph = __float2int_rz((static_cast<float>(row) + 0.5f) * inv_nj);
          const int j = ja + row - dph * nj;
          const int sp = ax.span[j];
          const T* gp = gb + dph * OUT * CS + v * kItem;
          float4 s[kF4], gv[kF4];
#pragma unroll
          for (int u = 0; u < kF4; ++u) s[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int pw = sp & 0xffff; pw <= sp >> 16; ++pw) {
            const float wt = ax.wt[pw][j - ax.start[pw]];
            smem_item(gp + pw * CS, gv);
#pragma unroll
            for (int u = 0; u < kF4; ++u) fma4(s[u], wt, gv[u]);
          }
#pragma unroll
          for (int u = 0; u < kF4; ++u) hsum[row * kQ + v * kF4 + u] = s[u];
        }
      }
      __syncthreads();  // H in place
      if (hit) {
        // Row pass: acc[y_i, x_j, q] += sum over the bins ph of tap i of Wy * H.
        const int ni = ib - ia;
        for (int item = tid; item < ni * nj * kV; item += kThreads) {
          const int v = item % kV;
          const int row = item / kV;
          if (v >= nvi) continue;
          const int di = __float2int_rz((static_cast<float>(row) + 0.5f) * inv_nj);
          const int jl = row - di * nj;
          const int i = ia + di;
          const int sp = ay.span[i];
          float4 s[kF4];
#pragma unroll
          for (int u = 0; u < kF4; ++u) s[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int ph = sp & 0xffff; ph <= sp >> 16; ++ph) {
            const float wt = ay.wt[ph][i - ay.start[ph]];
            const float4* hp = hsum + ((ph - ph_lo) * nj + jl) * kQ + v * kF4;
#pragma unroll
            for (int u = 0; u < kF4; ++u) fma4(s[u], wt, hp[u]);
          }
          float4* d = acc + ((ay.tap[i] - y0) * TX + ax.tap[ja + jl] - x0) * kQ + v * kF4;
#pragma unroll
          for (int u = 0; u < kF4; ++u) {
            d[u].x += s[u].x;
            d[u].y += s[u].y;
            d[u].z += s[u].z;
            d[u].w += s[u].w;
          }
        }
      }
    }
  }
  __syncthreads();

  // 3. The tile, once: 16-byte vectors of the gradient's dtype.
  constexpr int kVec = Vec<T>::kWidth;
  constexpr int kVecs = CS / kVec;
  const int nv = nc / kVec;
  T* out = pick(pyr.grad, lv) + static_cast<size_t>(frame) * h * w * channels + c0;
  for (int item = tid; item < TY * TX * kVecs; item += kThreads) {
    const int v = item % kVecs;
    const int p = item / kVecs;
    const int y = y0 + p / TX;
    const int x = x0 + p % TX;
    if (v >= nv || y >= h || x >= w) continue;
    float vals[kVec];
#pragma unroll
    for (int u = 0; u < kVec / 4; ++u) {
      const float4 a4 = acc[p * kQ + v * (kVec / 4) + u];
      vals[4 * u] = a4.x;
      vals[4 * u + 1] = a4.y;
      vals[4 * u + 2] = a4.z;
      vals[4 * u + 3] = a4.w;
    }
    *reinterpret_cast<uint4*>(out + (y * w + x) * channels + v * kVec) = Vec<T>::pack(vals);
  }
}

template <typename T, int OUT>
cudaError_t launch_backward(GradPyramid<T> pyr, const void* g, const float* rois, const int* levels, void* scratch,
                            int num_frames, int num_rois, int rois_per_frame, int channels, cudaStream_t stream) {
  using Tl = BwdTile<OUT>;
  auto* recs = static_cast<BwdRoi<OUT>*>(scratch);
  auto* boxes = reinterpret_cast<int4*>(recs + num_rois);
  roi_geometry_kernel<T, OUT><<<(num_rois + kGeomRois - 1) / kGeomRois, 64 * kGeomRois, 0, stream>>>(
      pyr, rois, levels, num_rois, recs, boxes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int tiles = 0;
  for (int l = 0; l < 4; ++l) {
    pyr.tiles_x[l] = (pyr.w[l] + Tl::kCols - 1) / Tl::kCols;
    tiles += (pyr.h[l] + Tl::kRows - 1) / Tl::kRows * pyr.tiles_x[l];
    pyr.tile_end[l] = tiles;
  }
  const int slices = (channels + Tl::kSlice - 1) / Tl::kSlice;
  const long long ctas = static_cast<long long>(num_frames) * tiles * slices;
  if (ctas == 0) return cudaSuccess;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  constexpr size_t smem = backward_smem_bytes<T, OUT>();
  // Opted into whatever the size: static and dynamic shared memory
  // together may pass 48 KB where the dynamic part alone does not.
  auto kernel = roi_align_backward_kernel<T, OUT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<int>(ctas), Tl::kThreads, smem, stream>>>(pyr, static_cast<const T*>(g), levels, recs, boxes,
                                                                   rois_per_frame, channels, slices);
  return cudaGetLastError();
}

template <typename T>
int backward_entry(const void* g, const void* rois, const void* levels, void* scratch, void* const grads[4],
                   const int hw[8], const float scales[4], int num_frames, int num_rois, int rois_per_frame,
                   int channels, int output_size, cudaStream_t stream) {
  GradPyramid<T> pyr = {};
  for (int l = 0; l < 4; ++l) {
    pyr.grad[l] = static_cast<T*>(grads[l]);
    pyr.h[l] = hw[2 * l];
    pyr.w[l] = hw[2 * l + 1];
    pyr.scale[l] = scales[l];
  }
  const float* r = static_cast<const float*>(rois);
  const int* lv = static_cast<const int*>(levels);
  cudaError_t err = cudaErrorInvalidValue;
  if (output_size == 7) {
    err = launch_backward<T, 7>(pyr, g, r, lv, scratch, num_frames, num_rois, rois_per_frame, channels, stream);
  } else if (output_size == 14) {
    err = launch_backward<T, 14>(pyr, g, r, lv, scratch, num_frames, num_rois, rois_per_frame, channels, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// feats: 4 pointers to NHWC levels [T, h_l, w_l, C], 16-byte aligned; rois:
// [num_rois, 4] f32 XYXY, frame-major (frame = roi / rois_per_frame);
// levels: [num_rois] int32 in 0..3; out: [num_rois, OUT, OUT, C] of the
// feature dtype, 16-byte aligned. C must be whole 16-byte vectors (a
// multiple of 8 in bf16, of 4 in f32).
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
  const int vec = is_bf16 ? 8 : 4;
  bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (const void* f : feats) aligned = aligned && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  bool small = true;  // offsets within one frame's level are ints
  for (int l = 0; l < 4; ++l) small = small && static_cast<long long>(hw[2 * l]) * hw[2 * l + 1] * channels <= INT_MAX;
  if (num_rois <= 0 || rois_per_frame <= 0 || channels <= 0 || channels % vec != 0 || !aligned || !small) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      is_bf16 ? launch_any<__nv_bfloat16>(output_size, feats, hw, scales, r, lv, num_rois, rois_per_frame, channels,
                                          out, st)
              : launch_any<float>(output_size, feats, hw, scales, r, lv, num_rois, rois_per_frame, channels, out, st);
  return static_cast<int>(err);
}

// Bytes of scratch the backward needs for `num_rois` rois at `output_size`
// (7 or 14; -1 otherwise): one geometry record and one box per roi.
long long sfvos_roi_align_backward_scratch_bytes(int output_size, int num_rois) {
  if (num_rois < 0) return -1;
  if (output_size == 7) return static_cast<long long>(backward_scratch_bytes<7>(num_rois));
  if (output_size == 14) return static_cast<long long>(backward_scratch_bytes<14>(num_rois));
  return -1;
}

// Backward (K5). Launches on `stream` and returns cudaGetLastError() (0 =
// ok). g: [num_rois, OUT, OUT, C] of the feature dtype; rois, levels as in
// the forward, num_rois = num_frames x rois_per_frame; scratch: at least
// sfvos_roi_align_backward_scratch_bytes(OUT, num_rois) bytes; grad0..3:
// the gradient of each level [num_frames, h_l, w_l, C] in g's dtype, which
// this writes whole (no zeroing needed). g, scratch and the gradients are
// 16-byte aligned; C is whole 16-byte vectors (a multiple of 8 in bf16, of
// 4 in f32).
int sfvos_roi_align_backward(const void* g, const void* rois, const void* levels, void* scratch,
                             long long scratch_bytes, void* grad0, void* grad1, void* grad2, void* grad3, int h0,
                             int w0, int h1, int w1, int h2, int w2, int h3, int w3, float s0, float s1, float s2,
                             float s3, int num_frames, int num_rois, int rois_per_frame, int channels,
                             int output_size, int is_bf16, void* stream) {
  void* const grads[4] = {grad0, grad1, grad2, grad3};
  const int hw[8] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const float scales[4] = {s0, s1, s2, s3};
  const int vec = is_bf16 ? 8 : 4;
  bool aligned = reinterpret_cast<uintptr_t>(g) % 16 == 0 && reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  bool small = true;  // offsets within one frame's level are ints
  for (int l = 0; l < 4; ++l) {
    aligned = aligned && grads[l] != nullptr && reinterpret_cast<uintptr_t>(grads[l]) % 16 == 0;
    small = small && static_cast<long long>(hw[2 * l]) * hw[2 * l + 1] * channels <= INT_MAX;
  }
  const long long need = sfvos_roi_align_backward_scratch_bytes(output_size, num_rois);
  if (num_rois <= 0 || rois_per_frame <= 0 || num_frames <= 0 ||
      static_cast<long long>(num_frames) * rois_per_frame != num_rois || channels <= 0 || channels % vec != 0 ||
      !aligned || !small || need < 0 || scratch_bytes < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? backward_entry<__nv_bfloat16>(g, rois, levels, scratch, grads, hw, scales, num_frames, num_rois,
                                                 rois_per_frame, channels, output_size, st)
                 : backward_entry<float>(g, rois, levels, scratch, grads, hw, scales, num_frames, num_rois,
                                         rois_per_frame, channels, output_size, st);
}

const char* sfvos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
