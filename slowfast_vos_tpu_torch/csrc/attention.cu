// Attention with decomposed relative positions for Hopper (sm_90a): K7.
//
// Replaces no TPU kernel: the JAX package has no transformer. K7 came with
// the ViTDet-B backbone (`slowfast_vos_tpu_torch/models/vit.py`), whose
// every block adds detectron2's decomposed relative-position bias to the
// logits (`add_decomposed_rel_pos`). The port's plain version is
// `slowfast_vos_tpu_torch/ops/attention.py::attention_plain`, the published
// materialized form. What it computes, per (batch, head) and query q of N
// tokens on an S_h x S_w key grid, in f32 from bf16 operands:
//
//   logit[q, k] = scale * (q . k) + rel_h[q, k / S_w] + rel_w[q, k % S_w]
//   out[q]      = sum_k softmax_k(logit[q, .]) v[k]
//
// with the softmax online over key tiles (running max and sum, f32) and the
// probabilities rounded to bf16 for the second product, as the plain
// version rounds them before `p @ v`. No [N, N] tensor exists in device
// memory: a tile's logits live in registers.
//
// Design: flash attention on Hopper's warpgroup products (`wgmma`, bf16
// in, f32 accumulators). One CTA is one warpgroup (4 warps) and takes 64
// queries of one (batch, head): S = Q K^T is one m64n64 product over 4
// k-steps with Q and K in shared memory; O += P V one m64n64 product with P
// from registers (S's accumulator, rounded) and V in shared memory. A
// row's max and sum stay inside the 4 lanes that hold it (two shuffles).
// A 1-D grid with the query blocks of one (batch, head) adjacent, so that
// the CTAs that re-read its keys and values run together and find them in
// L2.
//  0. The CTA's queries and the first key tile go to shared memory by
//     `cp.async`, in wgmma's 128-byte swizzle (rows of 64 bf16, chunk c of
//     row r at c ^ (r % 8)); its queries' rows of rel_h and rel_w (S_h, S_w
//     <= 64 entries each) by plain loads.
//  1. Per key tile of 64 (keys past N are zeros): the next tile's copies
//     go out into the other of two stages; S; the scale and both terms
//     added in f32 (global blocks: a tile is one key row, S_w = 64, so its
//     rel_h entry is the tile's index and its rel_w entry the column, kept
//     in registers; otherwise each key's row and column come from a table
//     the tile fills), keys past N set to -inf, the online softmax in base
//     2; O += P V.
//  2. O / l rounded to bf16, written as [B, N, heads, 64], the layout the
//     output projection reads.
// Bounds (H100 SXM, bf16, 989 TFLOP/s, 3.35 TB/s): global blocks of ViTDet-B
// (N = 4096) by the tensor cores, window blocks (N = 196) by memory
// (`vosbench/yardstick_vitdet.py::attention_call`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kD = 64;            // head size
constexpr int kBlockM = 64;       // queries a CTA: one wgmma row block
constexpr int kBlockN = 64;       // keys a tile
constexpr int kThreads = 128;     // one warpgroup
constexpr int kMaxS = 64;         // the key grid's sides
constexpr int kRelLd = kMaxS + 2; // a padded row of rel_h, rel_w: 33 words, so 8 rows take 8 banks
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileBytes = kBlockN * kD * 2;  // 8 KB: 64 rows of 128 bytes, 128-byte swizzled

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* rh;
  const __nv_bfloat16* rw;
  __nv_bfloat16* o;
  long long sq_b, sq_h, sq_n, sk_b, sk_h, sk_n, sv_b, sv_h, sv_n;
  long long srh_b, srh_h, srh_n, srw_b, srw_h, srw_n, so_b, so_n, so_h;
  int heads, n, s_h, s_w, m_blocks;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 64 rows of 64 bf16 (row stride `stride` elements, 16-byte aligned) into a
// tile of 64 rows of 128 bytes whose 16-byte chunks are swizzled as wgmma's
// 128-byte mode reads them (chunk c of row r at c ^ (r % 8); the tile
// 1024-byte aligned), by `cp.async`, zeros past `rows`: the copies land
// while the CTA computes on the other stage. One commit group.
__device__ __forceinline__ void load_tile_async(unsigned char* dst, const __nv_bfloat16* src, long long stride,
                                                int rows) {
  #pragma unroll
  for (int step = 0; step < kBlockN * (kD / 8) / kThreads; ++step) {
    const int i = threadIdx.x + step * kThreads;
    const int r = i / (kD / 8);
    const int c = i % (kD / 8);
    const bool in = r < rows;
    const __nv_bfloat16* from = in ? src + r * stride + c * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst + r * 128 + ((c ^ (r & 7)) << 4))),
                 "l"(from), "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// wgmma's descriptor of a 128-byte swizzled operand in shared memory at
// `addr`: 8-row groups 1024 bytes apart, the leading offset unused (one
// swizzle atom across).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// c (64 x 64 f32 over the warpgroup) = or += a b: a from shared memory,
// K-major (a row's 16 k-values contiguous); b from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float* c, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]), "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]), "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]), "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]), "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// c += a b: a from registers (m16n8k16's A fragment for each warp's 16
// rows); b from shared memory, N-major (a row of 64 n-values per k).
__device__ __forceinline__ void wgmma_rs(float* c, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]), "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]), "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]), "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]), "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_regs(float* r) {
  #pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Dynamic shared memory of a CTA (1024-byte aligned tiles first): the
// queries, two stages of keys and of values, the queries' rows of both
// terms, two stages of the key table.
constexpr int kOffQ = 0;
constexpr int kOffK = kTileBytes;
constexpr int kOffV = 3 * kTileBytes;
constexpr int kOffRel = 5 * kTileBytes;
constexpr int kOffTab = kOffRel + 2 * kBlockM * kRelLd * 2;
constexpr int kSmemBytes = kOffTab + 2 * 2 * kBlockN * 4 + 1024;  // + room to align the base

template <bool kRowTiles>
__global__ void __launch_bounds__(kThreads) k7_rel_pos_attention_kernel(Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* s_q = smem + kOffQ;
  unsigned char* s_k = smem + kOffK;  // [2] stages
  unsigned char* s_v = smem + kOffV;  // [2] stages
  __nv_bfloat16* s_rh = reinterpret_cast<__nv_bfloat16*>(smem + kOffRel);  // [kBlockM][kRelLd]
  __nv_bfloat16* s_rw = s_rh + kBlockM * kRelLd;
  int* s_kh = reinterpret_cast<int*>(smem + kOffTab);  // [2][kBlockN]: a key's grid row, -1 past N
  int* s_kw = s_kh + 2 * kBlockN;                      // [2][kBlockN]: its grid column

  const int bh = blockIdx.x / p.m_blocks;
  const int m0 = (blockIdx.x % p.m_blocks) * kBlockM;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int n = p.n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragment's row (and row + 8)
  const int t = lane % 4;  // the fragment's column pair
  const __nv_bfloat16* k_base = p.k + b * p.sk_b + h * p.sk_h;
  const __nv_bfloat16* v_base = p.v + b * p.sv_b + h * p.sv_h;
  const int tiles = (n + kBlockN - 1) / kBlockN;

  // Key table of the tile at `start` into stage `st` (tiles that cross
  // grid rows).
  auto fill_table = [&](int start, int st) {
    if (!kRowTiles && threadIdx.x < kBlockN) {
      const int key = start + threadIdx.x;
      const int kh = key / p.s_w;
      s_kh[st * kBlockN + threadIdx.x] = key < n ? kh : -1;
      s_kw[st * kBlockN + threadIdx.x] = key - kh * p.s_w;
    }
  };

  // 0. the queries' and the first tile's copies in flight; the queries'
  // rows of both terms (the columns a key can index).
  const int m_rows = min(kBlockM, n - m0);
  load_tile_async(s_q, p.q + b * p.sq_b + h * p.sq_h + m0 * p.sq_n, p.sq_n, m_rows);
  load_tile_async(s_k, k_base, p.sk_n, min(kBlockN, n));
  load_tile_async(s_v, v_base, p.sv_n, min(kBlockN, n));
  fill_table(0, 0);
  const __nv_bfloat16* rh = p.rh + b * p.srh_b + h * p.srh_h + m0 * p.srh_n;
  const __nv_bfloat16* rw = p.rw + b * p.srw_b + h * p.srw_h + m0 * p.srw_n;
  const int s_max = max(p.s_h, p.s_w);
  for (int i = threadIdx.x; i < kBlockM * s_max; i += kThreads) {
    const int r = i / s_max;
    const int c = i % s_max;
    const bool in = r < m_rows;
    s_rh[r * kRelLd + c] = (in && c < p.s_h) ? rh[r * p.srh_n + c] : __float2bfloat16(0.0f);
    s_rw[r * kRelLd + c] = (in && c < p.s_w) ? rw[r * p.srw_n + c] : __float2bfloat16(0.0f);
  }
  __syncthreads();

  const int row0 = warp * 16 + g;  // this lane's rows in the CTA: row0, row0 + 8
  // Row tiles: a key's rel_w entry is its column, the same in every tile;
  // kept in registers, in base 2.
  float rw_reg[kRowTiles ? 32 : 1];
  if (kRowTiles) {
    #pragma unroll
    for (int i = 0; i < (kRowTiles ? 32 : 1); ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      rw_reg[i] = kLog2e * __bfloat162float(s_rw[row * kRelLd + col]);
    }
  }

  float acc[32];  // O: 64 x 64 over the warpgroup, wgmma's accumulator layout
  float s[32];    // S, then P, of the tile
  #pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, base 2, of rows row0 and row0 + 8
  float l_run[2] = {0.0f, 0.0f};            // this lane's share of the running sum
  const float scale2 = p.scale * kLog2e;
  const uint64_t desc_q = smem_desc(smem_addr(s_q));

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    const int start = it * kBlockN;
    if (it + 1 < tiles) {  // the next tile into the other stage (free: the last iteration ended on a barrier)
      const int next = start + kBlockN;
      load_tile_async(s_k + (st ^ 1) * kTileBytes, k_base + next * p.sk_n, p.sk_n, min(kBlockN, n - next));
      load_tile_async(s_v + (st ^ 1) * kTileBytes, v_base + next * p.sv_n, p.sv_n, min(kBlockN, n - next));
      fill_table(next, st ^ 1);
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the copies, seen by wgmma
    __syncthreads();

    // 1a. S = Q K^T: 4 k-steps of 16 (32 bytes along a swizzled row).
    const uint64_t desc_k = smem_desc(smem_addr(s_k + st * kTileBytes));
    fence_regs(s);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) wgmma_ss(s, desc_q + 2 * ks, desc_k + 2 * ks, ks);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // 1b. scale, both terms, the mask; in base 2. s[i]: row row0 + 8 *
    // ((i >> 1) & 1), column 8 * (i >> 2) + 2t + (i & 1).
    float tile_max[2] = {-INFINITY, -INFINITY};
    float rh_tile[2] = {0.0f, 0.0f};
    if (kRowTiles) {
      rh_tile[0] = kLog2e * __bfloat162float(s_rh[row0 * kRelLd + it]);
      rh_tile[1] = kLog2e * __bfloat162float(s_rh[(row0 + 8) * kRelLd + it]);
    }
    const int* kh_tab = s_kh + st * kBlockN;
    const int* kw_tab = s_kw + st * kBlockN;
    #pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x;
      if (kRowTiles) {
        x = fmaf(s[i], scale2, rh_tile[r] + rw_reg[kRowTiles ? i : 0]);
      } else {
        const int col = 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = row0 + 8 * r;
        const int kh = kh_tab[col];
        x = kh < 0 ? -INFINITY
                   : fmaf(s[i], scale2,
                          kLog2e * (__bfloat162float(s_rh[row * kRelLd + kh]) +
                                    __bfloat162float(s_rw[row * kRelLd + kw_tab[col]])));
      }
      s[i] = x;
      tile_max[r] = fmaxf(tile_max[r], x);
    }
    float alpha[2];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_run[r], tile_max[r]);  // finite: every tile holds a key below N
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    #pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pe = exp2f(s[i] - m_run[(i >> 1) & 1]);
      s[i] = pe;
      l_run[(i >> 1) & 1] += pe;
      acc[i] *= alpha[(i >> 1) & 1];
    }

    // 1c. O += P V: P's A fragment for keys 16kk..+15 is S's accumulator of
    // columns 16kk..+15, rounded to bf16; V's k-step is 16 rows (2048
    // bytes) further.
    uint32_t pa[kBlockN / 16][4];
    #pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      #pragma unroll
      for (int q = 0; q < 4; ++q) pa[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
    }
    const uint64_t desc_v = smem_desc(smem_addr(s_v + st * kTileBytes));
    fence_regs(acc);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) wgmma_rs(acc, pa[kk], desc_v + (2048 >> 4) * kk);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncthreads();  // this stage is read: the next iteration may refill it
  }

  // 2. O / l, bf16, rows below N. acc[i]: row row0 + 8 * ((i >> 1) & 1),
  // column 8 * (i >> 2) + 2t + (i & 1).
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = m0 + row0 + 8 * r;
    if (row >= n) continue;
    const float inv = 1.0f / l_run[r];
    __nv_bfloat16* out = p.o + b * p.so_b + row * p.so_n + h * p.so_h + 2 * t;
    #pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// K7 on `stream`: q, k, v [B, heads, N, 64] bf16 at the given element
// strides (the last unit; every row 16-byte aligned), rel_h [B, heads, N,
// S_h] and rel_w [B, heads, N, S_w] bf16 (last stride unit), out [B, N,
// heads, 64] bf16 at its strides (the last unit, the head's 64 contiguous).
// S_h * S_w == N, S_h and S_w at most 64. Returns 0 or a cudaError_t.
int sfvos_k7_attention(const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w, void* out,
                       const long long* strides, int batch, int heads, int n, int s_h, int s_w, float scale,
                       void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || s_h < 1 || s_w < 1 || s_h > kMaxS || s_w > kMaxS || s_h * s_w != n ||
      !aligned16(q) || !aligned16(k) || !aligned16(v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 9; ++i) {
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.rh = static_cast<const __nv_bfloat16*>(rel_h);
  p.rw = static_cast<const __nv_bfloat16*>(rel_w);
  p.o = static_cast<__nv_bfloat16*>(out);
  long long* dst[18] = {&p.sq_b, &p.sq_h, &p.sq_n, &p.sk_b, &p.sk_h, &p.sk_n, &p.sv_b, &p.sv_h, &p.sv_n,
                        &p.srh_b, &p.srh_h, &p.srh_n, &p.srw_b, &p.srw_h, &p.srw_n, &p.so_b, &p.so_n, &p.so_h};
  for (int i = 0; i < 18; ++i) *dst[i] = strides[i];
  p.heads = heads;
  p.n = n;
  p.s_h = s_h;
  p.s_w = s_w;
  p.m_blocks = (n + kBlockM - 1) / kBlockM;
  p.scale = scale;
  const long long grid = static_cast<long long>(batch) * heads * p.m_blocks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool row_tiles = s_w == kBlockN && n % kBlockN == 0;
  const void* kernel = row_tiles ? reinterpret_cast<const void*>(&k7_rel_pos_attention_kernel<true>)
                                 : reinterpret_cast<const void*>(&k7_rel_pos_attention_kernel<false>);
  // Above the 48 KB a launch gets unasked; not a stream operation, so it is
  // allowed while the stream is captured into a graph.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (row_tiles) {
    k7_rel_pos_attention_kernel<true><<<static_cast<unsigned>(grid), kThreads, kSmemBytes, st>>>(p);
  } else {
    k7_rel_pos_attention_kernel<false><<<static_cast<unsigned>(grid), kThreads, kSmemBytes, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sfvos_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
