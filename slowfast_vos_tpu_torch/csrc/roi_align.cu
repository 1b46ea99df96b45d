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
  constexpr int kS = Axis<OUT>::kSamples;
  constexpr int kCand = Axis<OUT>::kCand;
  static_assert(CS % kVec == 0, "a slice is whole 16-byte vectors");
  static_assert(kS <= 32 && kThreads >= 64, "a warp per axis, a lane per sample");

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

  // 1. Geometry: warp a builds axis a (0: y, 1: x), lane s takes sample s.
  // Valid samples' taps are nondecreasing (lo_s <= hi_s <= lo_s + 1, both
  // monotone in s), so a candidate tap is new exactly where it exceeds the
  // largest tap before it, and new taps come in ascending order: a tap's
  // index among the distinct taps is the count of new ones up to its
  // position, less one, less one more where a larger tap came before it
  // (only lo_s can follow a larger tap, hi_{s-1} = lo_s + 1).
  if (tid < 64) {
    const int a = tid / 32;
    const int lane = tid % 32;
    Axis<OUT>& ax = axes[a];
    Tap t = {0, 0, 0.0f, 0.0f, false};
    if (lane < kS) {
      const float lo_corner = __fmul_rn(rois[4 * r + 1 - a], scale);   // y1 or x1
      const float hi_corner = __fmul_rn(rois[4 * r + 3 - a], scale);   // y2 or x2
      const float extent = fmaxf(__fsub_rn(hi_corner, lo_corner), 1.0f);
      const float step = __fdiv_rn(__fdiv_rn(extent, static_cast<float>(OUT)),
                                   static_cast<float>(kSamplingRatio));
      t = make_tap(lo_corner, step, lane, a == 0 ? h : w);
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
    const int stride = a == 0 ? w * channels : channels;
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

const char* sfvos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
