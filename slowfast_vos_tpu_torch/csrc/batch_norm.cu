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
// Design: each direction is one cooperative launch of one kernel
// (`bn_forward_kernel`, `bn_backward_kernel`) on a persistent grid no larger
// than what is co-resident (at most one CTA per SM; the wrapper's
// `ops/batch_norm.py::plan`, a function of the shape and the SM count, gives
// the grid, the tile and the tiles a CTA keeps).
//  A. CTA b owns tiles b, b + G, b + 2G, ... of tile_rows rows each (G CTAs;
//     interleaved, so that the grid reads neighbouring tiles at once: a
//     contiguous range a CTA was measured 0.7-1.8% slower over a training
//     step's calls on an H100). One thread streams them into a ring of
//     `slots` tiles in dynamic shared memory with TMA, one mbarrier per
//     slot: a tile of x, or of a dense dy, is one 1-D bulk copy
//     (`cp.async.bulk`; 2-D tensor-map boxes were measured no faster on an
//     H100); a tile of a channel-slice dy is one 2-D box
//     (`cp.async.bulk.tensor`) of a tensor map that takes its rows as 8-byte
//     words and carries the row stride (a copy a row was measured ~45%
//     slower over a step's backward; a slice whose rows a box cannot span,
//     over 2048 bytes, is refused: no call of the model makes one). A thread
//     owns one 16-byte channel vector and every L-th row of a tile (L row
//     lanes), reads four rows at once and sums a tile's rows in f32
//     registers in row order, then adds that into its running sums in
//     double, so that no f32 chain is longer than a tile's share of rows
//     (one chain over a CTA's share, ~200 rows at the largest call, left the
//     statistics 5.1e-7 of E[x^2] from float64 against 1.9e-7 folded, for
//     ~1.5% of a step's calls' time on an H100); the lanes' sums meet in
//     shared memory and are added in a fixed order, in double, into the
//     CTA's partial, [grid, 2, C] in the caller's workspace.
//  B. Grid barrier (`cooperative_groups::this_grid().sync()`). Finalize: CTA
//     b takes channels b, b + grid, ..., a warp each; the warp adds the
//     channel's grid partials in a fixed order (lane l takes partials l,
//     l+32, ..., then a fixed butterfly) in double and computes the
//     statistics (forward: mean, var, invstd, k, the running update;
//     backward: dgamma, dbeta) and the elementwise pass's three coefficients
//     into the workspace. A second grid barrier publishes them. (A grid of
//     one thread-block cluster, its partials met through distributed shared
//     memory and cluster barriers in place of the grid barriers, was
//     measured slower on an H100 wherever a CTA had more than one tile: an
//     SM streams ~25 GB/s, so 16 CTAs lose more than the barriers cost.)
//  C. The elementwise pass (normalize / apply) walks the CTA's tiles in
//     reverse: the last `slots` tiles are still in shared memory; each
//     earlier one is read again into the slot just freed, most recently read
//     first, so that what the L2 still holds is met before device memory.
//     (L2 evict-first hints on the loads not read again and on the stores
//     were measured to change nothing on an H100, and are not used.)
// A call whose tiles all fit its CTAs' slots ("on-chip" route: most of a
// training step's calls) reads x, and dy, from device memory once; a larger
// one ("stream" route) reads again only what neither shared memory nor the
// L2 kept. No atomics in any sum: every sum has one order for a given plan,
// so two calls, and a CUDA graph's replay, agree bit for bit. Nothing is read
// back to the host and nothing is allocated here: workspace (partials,
// coefficients) comes from the caller.
//
// Bound: bytes. The forward must read x and write y once (2 N C element
// bytes), the backward read x and dy and write dx once (3 N C); the on-chip
// route moves exactly that, and the stream route adds the re-read of what
// did not stay on chip. The arithmetic, ~10 f32 operations an element, is
// far below the card's rate. What is left above the bound, as measured on an
// H100: ~9 us a call that moves no data (the launch, the two grid barriers,
// the first tile's arrival, the finalize's round trips to the L2), the
// phases' one-way rates (the sums read at ~2.3 TB/s, the elementwise pass
// writes at ~1.9), and in the stream route the re-read.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // a CTA; one CTA per SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 1024;       // channels a call takes: C / vector <= kThreads
constexpr int kMaxTileRows = 256;   // rows of a tile: a TMA box's height at most
constexpr int kMaxBoxRowBytes = 2048;  // a channel-slice dy's row: a TMA box of 256 8-byte elements
constexpr int kMaxSlots = 64;     // tiles a CTA keeps: one mbarrier parity bit each
constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may have on sm_90

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

struct Params {
  CUtensorMap dy_map;      // backward, dy a channel slice: its rows as 8-byte words, box [tile_rows, row]
  const void* x;           // [rows, c]
  const void* dy;          // backward: rows dy_stride elements apart
  long long dy_stride;
  const float* weight;     // [c]
  const float* bias;
  const float* stats_in;   // backward: the forward's [4, c] mean, var, invstd, k
  float* stats;            // forward: [4, c] out
  float* running_mean;     // forward: [c], updated in place
  float* running_var;
  float* dweight;          // backward: [c], may be null
  float* dbias;
  double* partials;        // [grid, 2, c] workspace
  float* coef;             // [3, c] workspace: the elementwise pass's coefficients
  void* out;               // y or dx, [rows, c]; the backward's may be null
  long long rows;
  int c, tile_rows, tiles, slots;
  unsigned tile_bytes;     // one tensor's tile in shared memory, 128-byte aligned
  float eps, momentum, one_minus_momentum;
};

// A CTA's dynamic shared memory, in bytes from its base: `slots` slots (a
// tile of x, then in the backward one of dy), the lanes' sums [lanes, 2, c]
// f32 (the coefficients [3, c] f32 once they are consumed: room for the
// larger), one mbarrier a slot.
struct Layout {
  unsigned lane_off, bar_off, total;
};

__host__ __device__ inline Layout layout(int c, int vec, bool grad, unsigned tile_bytes, int slots) {
  Layout l;
  const unsigned lanes = kThreads / (c / vec);
  l.lane_off = static_cast<unsigned>(slots) * tile_bytes * (grad ? 2u : 1u);
  l.bar_off = l.lane_off + (lanes > 1 ? 2u * lanes : 3u) * c * 4u;  // a multiple of 8
  l.total = l.bar_off + static_cast<unsigned>(slots) * 8u;
  return l;
}

// Bytes of one tensor's tile in shared memory, [tile_rows, c], rounded up to
// 128.
__host__ __device__ inline unsigned tile_bytes_of(int c, int elem, int tile_rows) {
  return (static_cast<unsigned>(tile_rows) * c * elem + 127u) & ~127u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory"); }

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` of the mbarrier to complete. A
// wait that polls 2^26 times (well over a second) traps: a load that never
// lands faults the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// A 1-D bulk copy of `bytes` (a multiple of 16) from `src` into shared
// memory at `dst`, counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// TMA: the box at (column x, row y) of `map` into shared memory at `dst`,
// its bytes counted on the mbarrier `bar`. Rows past the tensor's end are
// filled with zeros (and counted).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Rows a thread reads from shared memory at once, before it adds them up.
constexpr int kRows = 4;

// This thread's vectors of rows r, r + lanes, ..., kRows of them below
// `here`, of a tile of x (and of dy), all loads issued before any is used.
template <bool kGrad, typename T, typename Raw>
__device__ __forceinline__ void load_rows(const T* xs, const T* ds, int r, int lanes, int here, int c,
                                          Raw (&qx)[kRows], Raw (&qd)[kRows]) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int row = r + u * lanes;
    if (row < here) {
      qx[u] = *reinterpret_cast<const Raw*>(xs + row * c);
      if constexpr (kGrad) qd[u] = *reinterpret_cast<const Raw*>(ds + row * c);
    }
  }
}

// The statistics of channel ch from its two grid sums (a, q) in double:
// forward the [4, c] statistics and the running update, backward dweight
// and dbias. Returns the elementwise pass's coefficients, (mean,
// invstd*gamma, beta) forward, (gamma*invstd, S1/N, S2*k/N) backward.
template <bool kGrad>
__device__ __forceinline__ float3 finalize_channel(const Params& p, int ch, double a, double q) {
  const int c = p.c;
  if constexpr (!kGrad) {
    const float mean = static_cast<float>(a / static_cast<double>(p.rows));
    const float ex2 = static_cast<float>(q / static_cast<double>(p.rows));
    const float raw = __fsub_rn(ex2, __fmul_rn(mean, mean));
    const float var = raw < 0.f ? 0.f : raw;  // clamp(min=0): NaN passes
    const float invstd = __frsqrt_rn(__fadd_rn(var, p.eps));
    p.stats[ch] = mean;
    p.stats[c + ch] = var;
    p.stats[2 * c + ch] = invstd;
    p.stats[3 * c + ch] = raw >= 0.f ? 1.f : 0.f;  // where clamp's gradient passes
    p.running_mean[ch] = __fadd_rn(__fmul_rn(p.momentum, p.running_mean[ch]), __fmul_rn(p.one_minus_momentum, mean));
    p.running_var[ch] = __fadd_rn(__fmul_rn(p.momentum, p.running_var[ch]), __fmul_rn(p.one_minus_momentum, var));
    return make_float3(mean, __fmul_rn(invstd, p.weight[ch]), p.bias[ch]);
  } else {
    const float sum_dy = static_cast<float>(a), sum_dy_xhat = static_cast<float>(q);
    if (p.dbias != nullptr) p.dbias[ch] = sum_dy;
    if (p.dweight != nullptr) p.dweight[ch] = sum_dy_xhat;
    const float n = static_cast<float>(p.rows);
    return make_float3(__fmul_rn(p.weight[ch], p.stats_in[2 * c + ch]), __fdiv_rn(sum_dy, n),
                       __fdiv_rn(__fmul_rn(sum_dy_xhat, p.stats_in[3 * c + ch]), n));
  }
}

// Forward (kGrad false): per-channel sums of x and x^2, the statistics, y.
// Backward (kGrad true): sums of dy' and dy' * xhat, dweight, dbias, dx.
template <typename T, bool kGrad, bool kRelu>
__device__ __forceinline__ void bn_body(const Params& p) {
  constexpr int V = Vec<T>::n;
  using Raw = typename Vec<T>::raw;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = p.c, vecs = c / V, lanes = kThreads / vecs;
  const int tid = threadIdx.x, lane = tid / vecs, c0 = (tid % vecs) * V;
  const bool active = lane < lanes;
  const int b = blockIdx.x, grid = gridDim.x, S = p.slots, R = p.tile_rows;
  const int n = (p.tiles - b + grid - 1) / grid;  // this CTA's tiles: b, b + grid, ...
  auto first_row = [&](int i) { return static_cast<long long>(b + i * grid) * R; };  // of this CTA's tile i
  const Layout lay = layout(c, V, kGrad, p.tile_bytes, S);
  float* lane_sums = reinterpret_cast<float*>(smem + lay.lane_off);
  const uint32_t base = smem_addr(smem), bar0 = base + lay.bar_off;
  const unsigned slot_bytes = p.tile_bytes * (kGrad ? 2u : 1u);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // Tile i of this CTA into slot i % S (thread 0 only).
  auto rows_in = [&](int i) {
    const long long left = p.rows - first_row(i);
    return left < R ? static_cast<int>(left) : R;
  };
  auto issue = [&](int i) {
    const int s = i % S;
    const uint32_t bar = bar0 + 8 * s, dst = base + s * slot_bytes;
    const long long row = first_row(i);
    const int rows = rows_in(i);
    const uint32_t row_bytes = c * sizeof(T), bytes = rows * row_bytes;
    // A TMA box counts its rows past the end too.
    const uint32_t dy_bytes = kGrad ? (p.dy_stride == c ? bytes : R * row_bytes) : 0u;
    mbar_expect(bar, bytes + dy_bytes);
    bulk_load(dst, static_cast<const T*>(p.x) + row * c, bytes, bar);
    if constexpr (kGrad) {
      if (p.dy_stride == c) {
        bulk_load(dst + p.tile_bytes, static_cast<const T*>(p.dy) + row * c, bytes, bar);
      } else {  // a channel slice: one box of its rows
        tma_load_2d(dst + p.tile_bytes, &p.dy_map, 0, static_cast<int>(row), bar);
      }
    }
  };
  if (tid == 0) {
    for (int i = 0; i < n && i < S; ++i) issue(i);
  }
  // The backward's per-channel constants of the forward: xhat and the
  // ReLU's mask.
  float mean[V], invstd[V], mul[V], beta[V];
  if constexpr (kGrad) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mean[k] = p.stats_in[c0 + k];
      invstd[k] = p.stats_in[2 * c + c0 + k];
      mul[k] = kRelu ? __fmul_rn(invstd[k], p.weight[c0 + k]) : 0.f;
      beta[k] = kRelu ? p.bias[c0 + k] : 0.f;
    }
  }
  auto x_tile = [&](int s) { return reinterpret_cast<const T*>(smem + s * slot_bytes) + c0; };
  auto dy_tile = [&](int s) { return reinterpret_cast<const T*>(smem + s * slot_bytes + p.tile_bytes) + c0; };

  // A. The CTA's sums: a tile's in f32 (s1, s2), all tiles' in double (d1, d2).
  float s1[V], s2[V];
  double d1[V], d2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) d1[k] = d2[k] = 0.0;
  uint64_t phases = 0;  // parity of each slot's next phase
  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    mbar_wait(bar0 + 8 * s, static_cast<uint32_t>(phases >> s) & 1u);
    phases ^= 1ull << s;
    if (active) {
      const T* xs = x_tile(s);
      const int here = rows_in(i);
      const T* ds = kGrad ? dy_tile(s) : nullptr;
#pragma unroll
      for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
      for (int r = lane; r < here; r += kRows * lanes) {
        Raw qx[kRows], qd[kRows];
        load_rows<kGrad>(xs, ds, r, lanes, here, c, qx, qd);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (r + u * lanes >= here) break;
          float xv[V];
          unpack(qx[u], xv);
          if constexpr (!kGrad) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              s1[k] += xv[k];
              s2[k] = fmaf(xv[k], xv[k], s2[k]);
            }
          } else {
            float dv[V];
            unpack(qd[u], dv);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              float d = dv[k];
              if (kRelu && !(normalized<T, false>(xv[k], mean[k], mul[k], beta[k]) > 0.f)) d = 0.f;
              const float xhat = __fmul_rn(__fsub_rn(xv[k], mean[k]), invstd[k]);
              s1[k] += d;
              s2[k] = fmaf(d, xhat, s2[k]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        d1[k] += s1[k];
        d2[k] += s2[k];
      }
    }
    if (i + S < n) {  // the slot takes tile i + S once every thread is done with it
      __syncthreads();
      if (tid == 0) issue(i + S);
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      lane_sums[lane * 2 * c + c0 + k] = static_cast<float>(d1[k]);
      lane_sums[lane * 2 * c + c + c0 + k] = static_cast<float>(d2[k]);
    }
  }
  __syncthreads();
  // The lanes' sums of each of the 2C outputs in double: `groups` thread
  // groups add every groups-th lane in order, then the groups' sums are
  // added in order (the groups' sums overwrite the lanes' in shared memory).
  const int outs = 2 * c;
  const int groups = max(1, min(kThreads / outs, lanes));
  double* part = p.partials + static_cast<long long>(b) * outs;
  if (groups == 1) {
    for (int o = tid; o < outs; o += kThreads) {
      double acc = 0.0;
      for (int l = 0; l < lanes; ++l) acc += lane_sums[l * outs + o];
      part[o] = acc;
    }
  } else {
    const int o = tid % outs, k = tid / outs;
    double acc = 0.0;
    if (k < groups) {
      for (int l = k; l < lanes; l += groups) acc += lane_sums[l * outs + o];
    }
    __syncthreads();
    double* group_sums = reinterpret_cast<double*>(lane_sums);
    if (k < groups) group_sums[k * outs + o] = acc;
    __syncthreads();
    if (tid < outs) {
      double sum = 0.0;
      for (int kk = 0; kk < groups; ++kk) sum += group_sums[kk * outs + tid];
      part[tid] = sum;
    }
  }

  // B. The statistics of this CTA's share of the channels.
  cg::grid_group g = cg::this_grid();
  g.sync();
  const int warp = tid / 32, wl = tid % 32;
  for (int ch = b + warp * grid; ch < c; ch += kWarps * grid) {
    double a = 0.0, q = 0.0;
    for (int pp = wl; pp < grid; pp += 32) {
      a += __ldcg(p.partials + static_cast<long long>(pp) * 2 * c + ch);
      q += __ldcg(p.partials + static_cast<long long>(pp) * 2 * c + c + ch);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (wl == 0) {
      const float3 k = finalize_channel<kGrad>(p, ch, a, q);
      p.coef[ch] = k.x;
      p.coef[c + ch] = k.y;
      p.coef[2 * c + ch] = k.z;
    }
  }
  if (kGrad && p.out == nullptr) return;  // dweight and dbias only
  g.sync();
  // The coefficients, read from the L2 once a CTA (a load a thread of the
  // same few lines from every CTA would queue on their L2 slices), into the
  // lanes' sums' room.
  float* coef_s = lane_sums;
  for (int i = tid; i < 3 * c; i += kThreads) coef_s[i] = __ldcg(p.coef + i);
  __syncthreads();

  // C. The elementwise pass, tiles in reverse: shared memory, then the L2.
  float k0[V], k1[V], k2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    k0[k] = coef_s[c0 + k];
    k1[k] = coef_s[c + c0 + k];
    k2[k] = coef_s[2 * c + c0 + k];
  }
  T* out = static_cast<T*>(p.out) + c0;
  for (int j = n - 1; j >= 0; --j) {
    const int s = j % S;
    if (j < n - S) {  // read again into the slot tile j + S left
      mbar_wait(bar0 + 8 * s, static_cast<uint32_t>(phases >> s) & 1u);
      phases ^= 1ull << s;
    }
    if (active) {
      const T* xs = x_tile(s);
      const long long row0 = first_row(j);
      const int here = rows_in(j);
      const T* ds = kGrad ? dy_tile(s) : nullptr;
      for (int r = lane; r < here; r += kRows * lanes) {
        Raw qx[kRows], qd[kRows];
        load_rows<kGrad>(xs, ds, r, lanes, here, c, qx, qd);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int row = r + u * lanes;
          if (row >= here) break;
          float xv[V];
          unpack(qx[u], xv);
          if constexpr (!kGrad) {
#pragma unroll
            for (int k = 0; k < V; ++k) xv[k] = normalized<T, kRelu>(xv[k], k0[k], k1[k], k2[k]);
            store(out + (row0 + row) * c, xv);
          } else {
            float dv[V];
            unpack(qd[u], dv);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              float d = dv[k];
              if (kRelu && !(normalized<T, false>(xv[k], mean[k], mul[k], beta[k]) > 0.f)) d = 0.f;
              const float xhat = __fmul_rn(__fsub_rn(xv[k], mean[k]), invstd[k]);
              dv[k] = __fmul_rn(k0[k], __fsub_rn(__fsub_rn(d, k1[k]), __fmul_rn(xhat, k2[k])));
            }
            store(out + (row0 + row) * c, dv);
          }
        }
      }
    }
    if (j >= S) {  // tile j - S goes into this slot once every thread is done with it
      __syncthreads();
      if (tid == 0) issue(j - S);
    }
  }
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads, 1) bn_forward_kernel(const __grid_constant__ Params p) {
  bn_body<T, false, kRelu>(p);
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads, 1) bn_backward_kernel(const __grid_constant__ Params p) {
  bn_body<T, true, kRelu>(p);
}

template <typename T, bool kGrad, bool kRelu>
void* kernel_of() {
  if constexpr (kGrad) {
    return reinterpret_cast<void*>(&bn_backward_kernel<T, kRelu>);
  } else {
    return reinterpret_cast<void*>(&bn_forward_kernel<T, kRelu>);
  }
}

void* kernel_for(int bf16, bool grad, bool relu) {
  if (bf16) {
    if (grad) return relu ? kernel_of<__nv_bfloat16, true, true>() : kernel_of<__nv_bfloat16, true, false>();
    return relu ? kernel_of<__nv_bfloat16, false, true>() : kernel_of<__nv_bfloat16, false, false>();
  }
  if (grad) return relu ? kernel_of<float, true, true>() : kernel_of<float, true, false>();
  return relu ? kernel_of<float, false, true>() : kernel_of<float, false, false>();
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// Codes of this file's own refusals (below 0; a cudaError_t otherwise).
constexpr int kBadShape = -1;
constexpr int kNoEncoder = -2;
constexpr int kEncodeFailed = -1000;  // minus the CUresult

// The tensor map of a channel slice dy: `rows` rows of `row_bytes` (a
// multiple of 16, at most kMaxBoxRowBytes) as 8-byte words, `stride_bytes`
// apart; a box is `tile_rows` whole rows, rows past the end read as zeros.
int encode_rows(CUtensorMap* map, const void* ptr, long long rows, int row_bytes, long long stride_bytes,
                int tile_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes / 8), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(row_bytes / 8), static_cast<cuuint32_t>(tile_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed - static_cast<int>(res);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What every call checks: a shape and plan the kernels take, 16-byte rows.
// Fills the plan's part of `prm` and the shared memory to request.
bool fill_plan(Params& prm, const void* x, int bf16, bool grad, long long rows, int c, int tile_rows, int grid,
               int slots, unsigned* smem) {
  const int vec = bf16 ? 8 : 4;
  if (rows < 1 || rows > INT_MAX - kMaxTileRows || c < vec || c > kMaxC || c % vec != 0) return false;
  if (tile_rows < 1 || tile_rows > kMaxTileRows || slots < 1 || slots > kMaxSlots || grid < 1) return false;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  if (grid > tiles || !aligned16(x)) return false;
  prm.rows = rows;
  prm.c = c;
  prm.tile_rows = tile_rows;
  prm.tiles = static_cast<int>(tiles);
  prm.slots = slots;
  prm.x = x;
  prm.tile_bytes = tile_bytes_of(c, bf16 ? 2 : 4, tile_rows);
  *smem = layout(c, vec, grad, prm.tile_bytes, slots).total;
  return *smem <= static_cast<unsigned>(kSmemMax);
}

// One cooperative launch: every CTA of the grid co-resident, or an error
// (cudaErrorCooperativeLaunchTooLarge where the card cannot hold it whole).
int launch(const Params& prm, int bf16, bool grad, bool relu, int grid, unsigned smem, cudaStream_t stream) {
  void* kernel = kernel_for(bf16, grad, relu);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<Params*>(&prm)};
  return static_cast<int>(cudaLaunchKernelExC(&cfg, kernel, args));
}

}  // namespace

extern "C" {

// Lifts the dynamic shared-memory cap of every K6 kernel on the current
// device to the sm_90 maximum; once per device before the first call.
// Returns a cudaError_t (0 = ok).
int sfvos_bn_prepare() {
  for (int bf16 = 0; bf16 < 2; ++bf16) {
    for (int grad = 0; grad < 2; ++grad) {
      for (int relu = 0; relu < 2; ++relu) {
        const cudaError_t err = cudaFuncSetAttribute(kernel_for(bf16, grad != 0, relu != 0),
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
  }
  return 0;
}

// The dynamic shared memory a CTA of this plan requests, in bytes
// (`ops/batch_norm.py::plan` computes the same).
int sfvos_bn_smem_bytes(int bf16, int grad, int c, int tile_rows, int slots) {
  return static_cast<int>(layout(c, bf16 ? 8 : 4, grad != 0, tile_bytes_of(c, bf16 ? 2 : 4, tile_rows), slots).total);
}

// K6's forward on `stream`: the statistics of x ([rows, c], f32 or bf16 as
// `bf16` says, rows contiguous, 16-byte aligned) into stats ([4, c] f32:
// mean, var, invstd, k), the running statistics ([c] f32) updated in place,
// and y ([rows, c], x's dtype, 16-byte aligned) normalized, with the ReLU
// where `relu`. weight and bias: [c] f32. The plan (tile_rows, grid, slots)
// from `ops/batch_norm.py::plan`. partials: grid * 2 * c f64,
// coef: 3 * c f32 of scratch. c a multiple of the 16-byte vector (8 bf16,
// 4 f32), at most 1024. Returns 0, a cudaError_t, or a refusal below 0.
int sfvos_bn_forward(const void* x, int bf16, long long rows, int c, int tile_rows, int grid, int slots,
                     const void* weight, const void* bias, void* running_mean, void* running_var, float eps,
                     float momentum, float one_minus_momentum, int relu, void* y, void* stats, void* partials,
                     void* coef, void* stream) {
  Params prm = {};
  unsigned smem = 0;
  if (!fill_plan(prm, x, bf16, false, rows, c, tile_rows, grid, slots, &smem) || !aligned16(y)) return kBadShape;
  prm.weight = static_cast<const float*>(weight);
  prm.bias = static_cast<const float*>(bias);
  prm.stats = static_cast<float*>(stats);
  prm.running_mean = static_cast<float*>(running_mean);
  prm.running_var = static_cast<float*>(running_var);
  prm.partials = static_cast<double*>(partials);
  prm.coef = static_cast<float*>(coef);
  prm.out = y;
  prm.eps = eps;
  prm.momentum = momentum;
  prm.one_minus_momentum = one_minus_momentum;
  return launch(prm, bf16, false, relu != 0, grid, smem, static_cast<cudaStream_t>(stream));
}

// K6's backward on `stream`, from the forward's x and stats: dy (rows
// dy_stride elements apart, x's dtype, 16-byte aligned; where it is a
// channel slice, its rows at most kMaxBoxRowBytes), the ReLU's mask
// recomputed from x, weight and bias where `relu`. Writes dbias = sum dy'
// and dweight = sum dy' * xhat ([c] f32) where they are not null, and dx
// ([rows, c], x's dtype) where it is not null. The plan as the forward's
// (the backward's own). partials: grid * 2 * c f64, coef: 3 * c f32 of
// scratch. Returns 0, a cudaError_t, or a refusal below 0.
int sfvos_bn_backward(const void* dy, long long dy_stride, const void* x, int bf16, long long rows, int c,
                      int tile_rows, int grid, int slots, const void* stats, const void* weight, const void* bias,
                      int relu, void* dx, void* dweight, void* dbias, void* partials, void* coef, void* stream) {
  const int vec = bf16 ? 8 : 4;
  Params prm = {};
  unsigned smem = 0;
  if (!fill_plan(prm, x, bf16, true, rows, c, tile_rows, grid, slots, &smem) || !aligned16(dy) ||
      dy_stride < c || dy_stride % vec != 0 || (dy_stride != c && c * (bf16 ? 2 : 4) > kMaxBoxRowBytes) ||
      (dx != nullptr && !aligned16(dx))) {
    return kBadShape;
  }
  prm.weight = static_cast<const float*>(weight);
  prm.bias = static_cast<const float*>(bias);
  prm.stats_in = static_cast<const float*>(stats);
  prm.dy = dy;
  prm.dy_stride = dy_stride;
  if (dy_stride != c) {
    const int rc = encode_rows(&prm.dy_map, dy, rows, c * (bf16 ? 2 : 4), dy_stride * (bf16 ? 2 : 4), tile_rows);
    if (rc != 0) return rc;
  }
  prm.dweight = static_cast<float*>(dweight);
  prm.dbias = static_cast<float*>(dbias);
  prm.partials = static_cast<double*>(partials);
  prm.coef = static_cast<float*>(coef);
  prm.out = dx;
  return launch(prm, bf16, true, relu != 0, grid, smem, static_cast<cudaStream_t>(stream));
}

const char* sfvos_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
