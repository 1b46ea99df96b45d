// Greedy non-maximum suppression for Hopper (sm_90a): K3.
//
// Replaces `slowfast_vos_tpu/ops/nms.py::_nms_fixpoint` (:27-55) and the
// blocked sweep of `nms_mask` (:96-136), which XLA computes there (a
// `while_loop` and a `scan`; there is no Pallas kernel for NMS, and the
// original system called torchvision's CUDA `nms`). What it computes, per
// problem p of a [P, N] batch of boxes already sorted by score (the caller
// sorts, gathers into score order and scatters back, as the JAX package does
// outside its loop):
//
//   alive[p, i] = valid[p, i] && no j < i with alive[p, j] && iou(j, i) > thr
//
// which is greedy NMS, the unique fixpoint of `_nms_fixpoint`. An invalid
// box is never kept and so never suppresses anything.
//
// Exactness: `iou` replays `ops/boxes.py::box_iou`'s float32 operations in
// their order, each rounded on its own, as PyTorch's separate elementwise
// kernels round them: area = (x2-x1)*(y2-y1); lt = max, rb = min; wh =
// clamp(rb-lt, min 0); inter = w*h; union = (area_j + area_i) - inter; iou =
// union > 0 ? inter/union : 0; then iou > thr in float32. The `__f*_rn`
// intrinsics keep nvcc from contracting `area_j + area_i - w*h` into an FMA
// (the shared build flags leave --fmad on), and the division stays a
// division. Max, min and the clamp are exact. A NaN coordinate makes the
// box's area NaN, so its union is NaN and its iou 0, here and in PyTorch.
//
// Design: torchvision's bitmask scheme, two launches per call over all P
// problems, with no host synchronize and a launch count that depends on the
// shapes only.
//  1. `nms_mask_kernel`: one CTA of 64 threads per (problem, 64-row block,
//     64-column block >= the row block); CTAs below the diagonal return at
//     once. The column block's boxes and areas go to shared memory; thread
//     r computes its row box's iou with each column box and writes one
//     uint64 word, bit k set iff column 64c+k > row and iou > thr. Every
//     (row, column block >= row block) word is written, so the scratch needs
//     no zeroing.
//  2. `nms_reduce_kernel`: one CTA of 512 threads per problem walks the
//     64-box blocks in order, keeping a `removed` bitset of the problem in
//     shared memory (N/8 bytes). For block b: 64 threads read the block's
//     diagonal words and valid flags at once; one thread resolves the block
//     on those bits (the lowest candidate left is kept and clears the bits
//     its diagonal word sets: one step per kept box, on shared memory); the
//     block's flags are written; then the CTA ORs the kept rows' words into
//     every later word of `removed`, a warp per 32 rows of one word (a warp
//     OR-reduce and one shared atomic per warp and word).
// Scratch (device memory the wrapper allocates): one uint64 per (problem,
// box, 64-box column block), P * N * ceil(N/64) * 8 bytes.
//
// Bound: operations. The pairwise iou is ~14 float32 operations a pair
// (4 min/max, 2 differences, 2 clamps, the product, the sum and the
// difference of the union, its test, the division, the threshold test), over
// up to N(N-1)/2 pairs per problem, against 17 bytes in (box, flag) and 1
// out per box. The reduce is a chain of N greedy steps per problem that no
// design removes; this one spends it as ceil(N/64) block steps, each a few
// shared-memory round trips and one round of loads of the kept rows' words,
// on P SMs. On an H100 those serial steps take half the time at the RPN's
// [8 frames x 5 levels, 1000] and most of it at larger N (`chip_smoke.py`
// phase 6 times the two kernels apart).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 64;           // boxes per bitmask word
constexpr int kReduceThreads = 512;  // threads of a reduce CTA (16 warps)

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// clamp(min=0) as PyTorch computes it: a NaN stays NaN.
__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// iou(a, b) > thr, `box_iou`'s operations in their order (see the head note).
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b, float thr) {
  const float w = clamp0(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
  const float h = clamp0(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  return iou > thr;
}

__global__ void __launch_bounds__(kBlock)
    nms_mask_kernel(const float4* __restrict__ boxes, int n, int words, float thr,
                    unsigned long long* __restrict__ mask) {
  const int row_block = blockIdx.y, col_block = blockIdx.x;
  if (row_block > col_block) return;
  const long long p = blockIdx.z;
  const float4* pb = boxes + p * n;
  __shared__ float4 cols[kBlock];
  __shared__ float col_area[kBlock];
  const int col0 = col_block * kBlock;
  const int col_n = min(n - col0, kBlock);
  if (threadIdx.x < col_n) {
    const float4 b = pb[col0 + threadIdx.x];
    cols[threadIdx.x] = b;
    col_area[threadIdx.x] = area_of(b);
  }
  __syncthreads();
  const int row = row_block * kBlock + threadIdx.x;
  if (row >= n) return;
  const float4 a = pb[row];
  const float area_a = area_of(a);
  unsigned long long bits = 0;
  for (int k = row_block == col_block ? threadIdx.x + 1 : 0; k < col_n; ++k) {
    if (overlaps(a, area_a, cols[k], col_area[k], thr)) bits |= 1ULL << k;
  }
  mask[(p * n + row) * words + col_block] = bits;
}

__global__ void __launch_bounds__(kReduceThreads)
    nms_reduce_kernel(const unsigned long long* __restrict__ mask, const bool* __restrict__ valid, int n,
                      int words, bool* __restrict__ alive) {
  extern __shared__ unsigned long long removed[];  // [words]
  __shared__ unsigned long long diag[kBlock];
  __shared__ unsigned valid_half[2];
  __shared__ unsigned long long kept_bits;
  const long long p = blockIdx.x;
  const unsigned long long* pm = mask + p * n * words;
  const bool* pv = valid + p * n;
  bool* pa = alive + p * n;
  const int tid = threadIdx.x;
  for (int w = tid; w < words; w += kReduceThreads) removed[w] = 0;
  __syncthreads();
  for (int b = 0; b < words; ++b) {
    const int base = b * kBlock;
    const int nb = min(n - base, kBlock);
    if (tid < kBlock) {  // warps 0 and 1: the block's diagonal words and flags
      const bool in = tid < nb;
      diag[tid] = in ? pm[static_cast<long long>(base + tid) * words + b] : 0ULL;
      const unsigned ballot = __ballot_sync(0xffffffffu, in && pv[base + tid]);
      if ((tid & 31) == 0) valid_half[tid >> 5] = ballot;
    }
    __syncthreads();
    if (tid == 0) {
      // Candidates in score order: valid and not removed by an earlier
      // block. The lowest one left is kept; its word removes later ones.
      unsigned long long todo =
          ((static_cast<unsigned long long>(valid_half[1]) << 32) | valid_half[0]) & ~removed[b];
      unsigned long long kept = 0;
      while (todo) {
        const int i = __ffsll(static_cast<long long>(todo)) - 1;
        kept |= 1ULL << i;
        todo &= ~(diag[i] | (1ULL << i));
      }
      kept_bits = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_bits;
    if (tid < nb) pa[base + tid] = (kept >> tid) & 1ULL;
    // Kept rows suppress the later words: item q is (row q % 64, word b + 1
    // + q / 64), so a warp holds 32 rows of one word; the bound is a
    // multiple of 64, so whole warps run each iteration.
    const int items = (words - b - 1) * kBlock;
    for (int q = tid; q < items; q += kReduceThreads) {
      const int r = q % kBlock, w = b + 1 + q / kBlock;
      const unsigned long long v = ((kept >> r) & 1ULL) ? pm[static_cast<long long>(base + r) * words + w] : 0ULL;
      const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
      const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
      if ((tid & 31) == 0 && (lo | hi)) atomicOr(&removed[w], (static_cast<unsigned long long>(hi) << 32) | lo);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Greedy NMS of `problems` problems of `n` score-sorted boxes: the mask
// kernel, then the reduce kernel, on `stream`; returns cudaGetLastError() (0
// = ok). boxes: [problems, n, 4] f32 XYXY, 16-byte aligned; valid, alive:
// [problems, n] bool; scratch: at least problems * n * ceil(n/64) * 8 bytes
// (one uint64 per problem, box and 64-box block), 8-byte aligned. 1 <=
// problems <= 65535 (the grid's z extent), 1 <= n <= 131072 (the removed
// bitset, n/8 bytes, stays within the 48 KB of dynamic shared memory a
// launch gets without opting in).
int sfvos_nms(const void* boxes, const void* valid, int problems, int n, float iou_threshold, void* scratch,
              long long scratch_bytes, void* alive, void* stream) {
  if (problems < 1 || problems > 65535 || n < 1 || n > (1 << 17) || reinterpret_cast<uintptr_t>(boxes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (n + kBlock - 1) / kBlock;
  if (scratch_bytes < static_cast<long long>(problems) * n * words * 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* mask = static_cast<unsigned long long*>(scratch);
  nms_mask_kernel<<<dim3(words, words, problems), kBlock, 0, st>>>(static_cast<const float4*>(boxes), n, words,
                                                                    iou_threshold, mask);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_reduce_kernel<<<problems, kReduceThreads, words * sizeof(unsigned long long), st>>>(
      mask, static_cast<const bool*>(valid), n, words, static_cast<bool*>(alive));
  return static_cast<int>(cudaGetLastError());
}

const char* sfvos_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
