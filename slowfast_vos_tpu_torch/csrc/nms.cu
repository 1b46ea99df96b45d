// Greedy non-maximum suppression for Hopper (sm_90a): K3.
//
// Replaces `slowfast_vos_tpu/ops/nms.py::_nms_fixpoint` (:27-55) and the
// blocked sweep of `nms_mask` (:96-136), which XLA computes there (a
// `while_loop` and a `scan`; there is no Pallas kernel for NMS, and the
// original system called torchvision's CUDA `nms`). What it computes, per
// problem p of a [P, N] batch of boxes in their original order, given the
// stable score order `order` (the caller's `torch.sort`) and the effective
// scores `eff` (scores, NEG_INF where the caller's flag is off): with
// i-th box b_i = boxes[p, order[p, i]] and flag v_i = eff[p, order[p, i]] >
// flag_min,
//
//   alive_i = v_i && no j < i with alive_j && iou(b_j, b_i) > thr
//   keep[p, order[p, i]] = alive_i
//
// which is greedy NMS, the unique fixpoint of `_nms_fixpoint`, scattered
// back to the original indices. An invalid box is never kept and so never
// suppresses anything.
//
// Exactness: `iou` replays `ops/boxes.py::box_iou`'s float32 operations in
// their order, each rounded on its own, as PyTorch's separate elementwise
// kernels round them: area = (x2-x1)*(y2-y1); lt = max, rb = min; wh =
// clamp(rb-lt, min 0); inter = w*h; union = (area_j + area_i) - inter; iou =
// union > 0 ? inter/union : 0; then iou > thr in float32. The `__f*_rn`
// intrinsics keep nvcc from contracting `area_j + area_i - w*h` into an FMA
// (the shared build flags leave --fmad on), and the division stays a
// division. A NaN coordinate makes the box's area NaN, so its union is NaN
// and its iou 0, here and in PyTorch. Exact early-out: a pair overlaps
// when both boxes have width and height > 0 and each one's right (bottom)
// edge lies beyond the other's left (top) edge, which is min(right edges) >
// max(left edges) on both axes, i.e. rb - lt > 0 (subnormals are kept).
// For every other pair the clamped width or height is 0 or NaN, so inter
// is 0 or NaN and `box_iou` gives iou 0 (0/union = +0; a NaN union or
// inter takes the zero branch): its bit is `0 > thr`, with no division. A
// box with a NaN coordinate has a NaN area and so iou 0 on either branch.
// Only the overlapping pairs pay the union and the division.
// `ops/nms.py::pair_overlaps_plain` is this test in PyTorch, held against
// `box_iou` on the CPU.
//
// Design: one launch per call, a thread-block cluster of C CTAs (1-16,
// the wrapper picks C from N) per problem; the 64-box column blocks are
// dealt out so that CTA c owns the blocks w = c (mod C).
//  0. Each CTA gathers its blocks' boxes, areas, original indices and
//     flags (a ballot per 32 boxes) into its shared memory; after a
//     cluster barrier every CTA copies all blocks' flags through
//     distributed shared memory.
//  1. Bitmask: row j's word of an owned block w, bit k set iff box 64w+k
//     comes after box j and suppresses it, for every valid row j <
//     64(w+1); the CTA's (block, row) items are one list dealt to its
//     threads in turn, and a row's box is read from its owner's shared
//     memory. A branch-free pass tests all 64 pairs for overlap (four
//     comparisons a pair), then only the overlapping ones (a find-first-set
//     loop over that mask, the next column loaded while one is tested) pay
//     the union and the division. Words stay in the CTA's shared memory
//     (N * ceil(W/C) * 8 bytes for W = ceil(N/64) blocks) where they fit
//     ("shared" route), else in device memory the wrapper allocates, laid
//     out alike ("global" route, 512 threads a CTA: its problems are large
//     and few, and more warps hide the bitmask's latencies).
//  2. Greedy reduce over the blocks in order. Warp k of a CTA owns its
//     blocks lw = k (mod warps): it keeps their `removed` words, resolves
//     each of them when its turn comes and ORs every earlier block's kept
//     rows into them. To resolve block b its warp holds the 64 diagonal
//     words in registers (two a lane, loaded ahead) and iterates
//     alive = cand & ~OR{diag_j : j alive} (a warp OR-reduce a round) to its
//     fixpoint, which is greedy NMS on the block's candidates. It then
//     sends the 64-bit kept word to every CTA of the cluster with
//     `st.async`, which lands it in that CTA's shared memory and completes
//     the transaction the CTA's mbarrier for block b expects; it writes
//     keep[order[...]] for the block; and every warp that owns a later
//     block waits on its CTA's mbarrier (acquire, cluster scope) and ORs the
//     kept rows' words (loaded before the wait) into its `removed`. No
//     device-memory load sits in the chain on the shared route; on the
//     global route the loads start before the wait. A cluster barrier
//     ends the kernel, so no CTA exits while another may still store into
//     its shared memory.
//
// Bound: operations. The pairwise iou is ~14 float32 operations a pair
// (4 min/max, 2 differences, 2 clamps, the product, the sum and the
// difference of the union, its test, the division, the threshold test), over
// up to N(N-1)/2 pairs per problem, against 17 bytes in (box, score, and the
// order's 8) and 1 out per box. What keeps K3 from that bound is the greedy
// chain, ceil(N/64) dependent block steps per problem that no design
// removes (each a warp's fixpoint rounds, one message through distributed
// shared memory and a warp OR-reduce), and the latency of the overlapping
// pairs' tests, which a warp runs as often as its busiest lane needs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kBlock = 64;      // boxes per bitmask word
constexpr int kMaxN = 1 << 16;  // the column data of 1024 blocks stays within a CTA's shared memory
constexpr unsigned kFull = 0xffffffffu;

// Threads of a CTA: 256 on the shared route, where a launch holds many
// clusters; 512 on the global route, whose problems are large and few, so
// more warps hide the bitmask's latencies on the cluster's SMs.
template <bool kGlobal>
constexpr int kThreads = kGlobal ? 512 : 256;

struct Params {
  const float4* boxes;     // [problems, n] XYXY, original order
  const float* eff;        // [problems, n] effective scores, original order
  const long long* order;  // [problems, n] stable score order: a permutation of 0..n-1
  bool* keep;              // [problems, n] out, original order
  u64* scratch;            // the global route's words
  int n, words, cluster, log_cluster, owned;  // cluster = 1 << log_cluster
  float thr, flag_min;
};

// Byte offsets into a CTA's dynamic shared memory. `owned` = ceil(W / C)
// blocks a CTA at most; every offset is a multiple of 8, the first of 16.
struct Layout {
  long long box, area, idx, valid_own, wide_own, kept, valid_all, removed, ready, words, total;
};

__host__ __device__ inline Layout layout(int n, int cluster, bool global) {
  const long long w = (n + kBlock - 1) / kBlock, owned = (w + cluster - 1) / cluster;
  Layout l;
  long long off = 0;
  l.box = off, off += 16LL * kBlock * owned;      // float4 per owned box
  l.area = off, off += 4LL * kBlock * owned;      // its area
  l.idx = off, off += 4LL * kBlock * owned;       // its original index
  l.valid_own = off, off += 8LL * owned;          // flags of the owned blocks, 32 a word
  l.wide_own = off, off += 8LL * owned;           // which owned boxes have width and height > 0
  l.kept = off, off += 8LL * w;                   // every block's kept word, as published
  l.valid_all = off, off += 8LL * w;              // every block's flags
  l.removed = off, off += 8LL * owned;            // owned blocks' removed words
  l.ready = off, off += 8LL * w;                  // every block's mbarrier: its kept word has landed
  l.words = off;
  if (!global) off += 8LL * owned * kBlock * w;   // [owned][64 W] words
  l.total = off;
  return l;
}


__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ bool wide(float4 b) { return b.z > b.x && b.w > b.y; }

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// The OR of the words of the rows set in `rows`: lane l holds rows l, l+32.
__device__ __forceinline__ u64 rows_or(u64 rows, int lane, u64 w0, u64 w1) {
  return warp_or((((rows >> lane) & 1ULL) ? w0 : 0ULL) | (((rows >> (lane + 32)) & 1ULL) ? w1 : 0ULL));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Store `kept` into slot b of CTA `rank`'s shared memory; the store
// completes the 8 bytes that slot's mbarrier expects there.
__device__ __forceinline__ void publish(u64* kept_slot, u64* bar_slot, u64 kept, unsigned rank) {
  uint32_t k, f;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(k) : "r"(smem_addr(kept_slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(f) : "r"(smem_addr(bar_slot)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, [%2];" ::"r"(k), "l"(kept), "r"(f)
               : "memory");
}

// Wait for this CTA's mbarrier of a block, then read the block's kept word.
__device__ __forceinline__ u64 receive(const u64* kept_slot, const u64* bar_slot) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar_slot)) : "memory");
  } while (done == 0u);
  u64 kept;
  asm volatile("ld.shared::cta.u64 %0, [%1];" : "=l"(kept) : "r"(smem_addr(kept_slot)) : "memory");
  return kept;
}

// Bit k of the result: box k of a column block (boxes `cb`, areas `ca`)
// comes after row box `a` and suppresses it, for the k in `todo`, the
// columns that overlap `a` on both axes. The loop walks the set bits in two
// 32-bit halves (cheaper than 64-bit steps) and divides without a branch
// around the division.
__device__ __forceinline__ u64 suppressed(float4 a, float area_a, u64 todo, const float4* cb, const float* ca,
                                          float thr) {
  unsigned lo = static_cast<unsigned>(todo), hi = static_cast<unsigned>(todo >> 32), out_lo = 0u, out_hi = 0u;
  while ((lo | hi) != 0u) {
    const bool in_lo = lo != 0u;
    const unsigned t = in_lo ? lo : hi;
    const int bit = __ffs(static_cast<int>(t)) - 1, k = in_lo ? bit : bit + 32;
    const unsigned rest = t & (t - 1);
    lo = in_lo ? rest : lo;
    hi = in_lo ? hi : rest;
    const float4 b = cb[k];
    const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));  // > 0: the clamp is the identity
    const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(area_a, ca[k]), inter);
    const float q = __fdiv_rn(inter, uni);
    const unsigned hit = (uni > 0.f ? q : 0.f) > thr ? 1u << bit : 0u;
    out_lo |= in_lo ? hit : 0u;
    out_hi |= in_lo ? 0u : hit;
  }
  return (static_cast<u64>(out_hi) << 32) | out_lo;
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads<kGlobal>, kGlobal ? 1 : 3) nms_cluster_kernel(const Params prm) {
  constexpr int kThr = kThreads<kGlobal>, kWarps = kThr / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = prm.n, nw = prm.words, C = prm.cluster, logc = prm.log_cluster, owned = prm.owned;
  const int c = static_cast<int>(cluster.block_rank());
  const long long p = blockIdx.x >> logc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L = layout(n, C, kGlobal);
  float4* col_box = reinterpret_cast<float4*>(smem + L.box);
  float* col_area = reinterpret_cast<float*>(smem + L.area);
  int* col_idx = reinterpret_cast<int*>(smem + L.idx);
  unsigned* valid_own = reinterpret_cast<unsigned*>(smem + L.valid_own);
  unsigned* wide_own = reinterpret_cast<unsigned*>(smem + L.wide_own);
  u64* kept_s = reinterpret_cast<u64*>(smem + L.kept);
  u64* valid_all = reinterpret_cast<u64*>(smem + L.valid_all);
  u64* removed = reinterpret_cast<u64*>(smem + L.removed);
  u64* ready = reinterpret_cast<u64*>(smem + L.ready);
  const long long stride = static_cast<long long>(kBlock) * nw;  // rows of one owned block's words
  u64* words = kGlobal ? prm.scratch + (p * C + c) * owned * stride : reinterpret_cast<u64*>(smem + L.words);
  // This CTA's blocks: lw * C + c for lw < mine.
  const int mine = (nw >> logc) + (((nw >> logc) << logc) + c < nw ? 1 : 0);
  const float4* boxes = prm.boxes + p * n;
  const float* eff = prm.eff + p * n;
  const long long* order = prm.order + p * n;

  // 0. The mbarriers, and the owned blocks' boxes in score order with their flags.
  for (int i = tid; i < nw; i += kThr) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(ready + i)) : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 8;" ::"r"(smem_addr(ready + i)) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (int i = tid; i < mine; i += kThr) removed[i] = 0ULL;
  for (int t = tid; t < mine * kBlock; t += kThr) {  // whole warps: the bound is a multiple of 64
    const int j = ((t / kBlock) * C + c) * kBlock + t % kBlock;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    int idx = 0;
    bool ok = false;
    if (j < n) {
      idx = static_cast<int>(order[j]);
      b = boxes[idx];
      ok = eff[idx] > prm.flag_min;
    }
    col_box[t] = b;
    col_area[t] = area_of(b);
    col_idx[t] = idx;
    const unsigned valid_bits = __ballot_sync(kFull, ok), wide_bits = __ballot_sync(kFull, wide(b));
    if (lane == 0) {
      valid_own[t / 32] = valid_bits;
      wide_own[t / 32] = wide_bits;
    }
  }
  cluster.sync();  // mbarriers set and column data written in every CTA before anyone reads or publishes
  for (int w = tid; w < nw; w += kThr) {
    const unsigned* v = cluster.map_shared_rank(valid_own, w & (C - 1)) + 2 * (w >> logc);
    valid_all[w] = (static_cast<u64>(v[1]) << 32) | v[0];
  }
  __syncthreads();

  // 1. Bitmask words of the owned blocks: row j's word of block w, for the
  // valid rows j < 64(w+1), as one list of (block, row) items dealt to the
  // CTA's threads in turn.
  const bool zero_bit = 0.f > prm.thr;  // the bit of a pair that does not overlap: iou 0
  auto rows_of = [&](int lw) {  // items of owned block lw: none where it has no candidate
    const int w = lw * C + c;
    return valid_all[w] == 0ULL ? 0 : min(n, (w + 1) * kBlock);
  };
  int lw = 0, base = 0, rows = mine > 0 ? rows_of(0) : 0;
  for (int q = tid;; q += kThr) {
    while (lw < mine && q >= base + rows) {
      base += rows;
      if (++lw < mine) rows = rows_of(lw);
    }
    if (lw >= mine) break;
    const int j = q - base, jb = j / kBlock, jk = j % kBlock;
    if (!((valid_all[jb] >> jk) & 1ULL)) continue;  // never kept: its word is never read
    const int w = lw * C + c, col0 = w * kBlock;
    const float4 a = cluster.map_shared_rank(col_box, jb & (C - 1))[(jb >> logc) * kBlock + jk];
    const float4* cb = col_box + lw * kBlock;
    // Columns after row j: all of a later block, those above jk on the diagonal.
    const u64 later = j < col0 ? ~0ULL : (jk == kBlock - 1 ? 0ULL : ~0ULL << (jk + 1));
    // Overlap on both axes: min(right edges) > max(left edges), which for a
    // box and a column that each have width and height > 0 is the four
    // comparisons below (a NaN box takes iou 0 on either branch).
    u64 touch = 0ULL;
    if (wide(a)) {
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        const float4 b = cb[k];
        if (a.z > b.x && b.z > a.x && a.w > b.y && b.w > a.y) touch |= 1ULL << k;
      }
      touch &= reinterpret_cast<const u64*>(wide_own)[lw];
    }
    const u64 bits = (zero_bit ? ~touch : 0ULL) |
                     suppressed(a, area_of(a), touch & later & valid_all[w], cb, col_area + lw * kBlock, prm.thr);
    words[lw * stride + j] = bits & later;
  }
  __syncthreads();

  // 2. The greedy reduce, block by block in score order (see the head note).
  if (warp < mine) {
    const int last = (warp + (mine - 1 - warp) / kWarps * kWarps) * C + c;  // the warp's last block
    int next = warp;  // the warp's first owned block not yet resolved
    u64 d0 = 0ULL, d1 = 0ULL;  // its diagonal words, rows lane and lane + 32
    auto load_diag = [&]() {
      const u64* col = words + next * stride + static_cast<long long>(next * C + c) * kBlock;
      d0 = col[lane];
      d1 = col[lane + 32];
    };
    load_diag();
    bool* keep = prm.keep + p * n;
    for (int b = 0; b <= last; ++b) {
      u64 kept;
      int first;  // the first of the warp's blocks that block b's kept rows update
      if (b == next * C + c) {
        const u64 cand = valid_all[b] & ~removed[next];
        u64 alive = cand;
        for (;;) {
          const u64 again = cand & ~rows_or(alive, lane, d0, d1);
          if (again == alive) break;
          alive = again;
        }
        kept = alive;
        if (lane < C) publish(kept_s + b, ready + b, kept, lane);
        const int j0 = b * kBlock;
        if (j0 + lane < n) keep[col_idx[next * kBlock + lane]] = (kept >> lane) & 1ULL;
        if (j0 + lane + 32 < n) keep[col_idx[next * kBlock + lane + 32]] = (kept >> (lane + 32)) & 1ULL;
        next += kWarps;
        if (next < mine) load_diag();
        first = next;
      } else {
        const u64* col = words + next * stride + static_cast<long long>(b) * kBlock;
        const u64 w0 = col[lane], w1 = col[lane + 32];  // loaded before the wait
        kept = receive(kept_s + b, ready + b);
        if (kept != 0ULL) {
          const u64 r = rows_or(kept, lane, w0, w1);
          if (lane == 0) removed[next] |= r;
        }
        first = next + kWarps;
      }
      if (kept != 0ULL) {
        for (int l = first; l < mine; l += kWarps) {
          const u64* col = words + l * stride + static_cast<long long>(b) * kBlock;
          const u64 r = rows_or(kept, lane, col[lane], col[lane + 32]);
          if (lane == 0) removed[l] |= r;
        }
      }
      __syncwarp();
    }
  }
  cluster.sync();  // no CTA leaves while another may still store into its shared memory
}

cudaLaunchConfig_t launch_config(int problems, int cluster, bool global, long long smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(problems * cluster));
  cfg.blockDim = dim3(global ? kThreads<true> : kThreads<false>);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_cluster(int cluster) { return cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16; }

template <bool kGlobal>
int prepare(int n, int cluster, int* max_clusters) {
  auto kernel = nms_cluster_kernel<kGlobal>;
  int device = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(fa.sharedSizeBytes));
  }
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, kGlobal, layout(n, cluster, kGlobal).total, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg));
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for `n` boxes a problem in clusters of
// `cluster` CTAs on the shared (global_route 0) or global route.
long long sfvos_nms_shared_bytes(int n, int cluster, int global_route) {
  return layout(n, cluster, global_route != 0).total;
}

// Lets the kernel of a route use the card's whole shared memory and
// clusters of 16, then writes into *max_clusters how many clusters of
// `cluster` CTAs with the shared memory of `n` boxes the card can hold at
// once (0: it cannot place one). Returns a cudaError_t (0 = ok). Call once
// per device and configuration before launching it.
int sfvos_nms_prepare(int n, int cluster, int global_route, int* max_clusters) {
  if (n < 1 || n > kMaxN || !valid_cluster(cluster) || max_clusters == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *max_clusters = 0;
  return global_route ? prepare<true>(n, cluster, max_clusters) : prepare<false>(n, cluster, max_clusters);
}

// Greedy NMS of `problems` problems of `n` boxes, one launch on `stream`, a
// cluster of `cluster` CTAs per problem; returns a cudaError_t (0 = ok).
// boxes: [problems, n, 4] f32 XYXY, 16-byte aligned; eff: [problems, n] f32;
// order: [problems, n] int64, each row a permutation of 0..n-1; keep:
// [problems, n] bool, every entry written. A box is a candidate iff its eff
// > flag_min. On the global route scratch holds at least problems * cluster
// * ceil(W / cluster) * 64 W * 8 bytes (W = ceil(n / 64)), 8-byte aligned;
// the shared route takes none. 1 <= n <= 65536; problems * cluster < 2^31.
int sfvos_nms(const void* boxes, const void* eff, const void* order, int problems, int n, int cluster,
              int global_route, float iou_threshold, float flag_min, void* scratch, long long scratch_bytes,
              void* keep, void* stream) {
  if (problems < 1 || n < 1 || n > kMaxN || !valid_cluster(cluster) || problems > INT_MAX / cluster ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  prm.boxes = static_cast<const float4*>(boxes);
  prm.eff = static_cast<const float*>(eff);
  prm.order = static_cast<const long long*>(order);
  prm.keep = static_cast<bool*>(keep);
  prm.scratch = static_cast<u64*>(scratch);
  prm.n = n;
  prm.words = (n + kBlock - 1) / kBlock;
  prm.cluster = cluster;
  prm.log_cluster = __builtin_ctz(static_cast<unsigned>(cluster));
  prm.owned = (prm.words + cluster - 1) / cluster;
  prm.thr = iou_threshold;
  prm.flag_min = flag_min;
  const bool global = global_route != 0;
  if (global && (reinterpret_cast<uintptr_t>(scratch) % 8 != 0 ||
                 scratch_bytes < static_cast<long long>(problems) * cluster * prm.owned * kBlock * prm.words * 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = global ? launch_config(problems, cluster, true, layout(n, cluster, true).total,
                                                              static_cast<cudaStream_t>(stream), &attr)
                                        : launch_config(problems, cluster, false, layout(n, cluster, false).total,
                                                               static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err = global ? cudaLaunchKernelEx(&cfg, nms_cluster_kernel<true>, prm)
                                 : cudaLaunchKernelEx(&cfg, nms_cluster_kernel<false>, prm);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

const char* sfvos_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
