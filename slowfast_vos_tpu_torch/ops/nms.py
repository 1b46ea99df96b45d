"""Fixed-shape NMS on torch tensors, batched over leading dimensions.

Port of `slowfast_vos_tpu/ops/nms.py`: the fixpoint form (`nms.py:27-55`)
and the blocked sweep (`nms.py:96-136`), and on the card K3, greedy NMS as a
hand-written CUDA kernel (`csrc/nms.cu`).
Like the JAX package it returns a keep *mask* over the original indices plus
the score order, and callers take a static top-k afterwards, so no output
shape depends on the data.

Ties: `jnp.argsort` is stable and `jax.lax.top_k` puts the lower index
first among equal values. `torch.topk` on CUDA promises no order among ties,
so every ordering here is a stable `torch.sort` and a slice.

`nms_mask(algorithm="auto")`, what every caller passes:

* on CUDA tensors: the effective scores and their stable sort in PyTorch
  (`effective_order`), then `nms_cuda`, K3 over every problem of the call
  at once (all leading dimensions flattened, e.g. [frames x FPN levels]):
  one launch, a thread-block cluster of `cluster_size(N)` CTAs per problem
  that reads the boxes through the order and writes the keep mask at the
  original indices itself (see the source's head note); no host
  synchronize, index-exact with the fixpoint. It replaces the JAX
  package's `_nms_fixpoint` and its blocked sweep, which XLA computes
  (there is no Pallas kernel for NMS). Its bound on an H100 is float32
  operations: ~14 per IoU pair over up to N(N-1)/2 pairs per problem,
  against 18 bytes of input and output per box; what keeps it from that
  bound is the greedy chain, ceil(N/64) dependent block steps per problem.
  The bitmask stays in the CTAs' shared memory up to `SHARED_ROUTE_MAX_N`
  boxes ("shared" route); above, it goes to device memory, N * ceil(N/64)
  * 8 bytes a problem ("global" route), and problems go in chunks of at
  most `SCRATCH_BUDGET` bytes, sized from the shapes alone.
* on CPU tensors, as the JAX package: `score_order` (sort and gather),
  then the fixpoint up to `FIXPOINT_MAX_N` boxes, else the blocked sweep,
  and a scatter back.

`algorithm="fixpoint"` and `"blocked"` are the plain versions on any device:
the oracles the kernel is held against.

The fixpoint runs on boxes of shape [..., N, 4] with any leading dimensions,
one [..., N, N] suppression matrix for the whole batch. The greedy result is
the unique fixpoint of each problem, so batching changes no answer; the loop
runs until every problem has converged, with one host synchronize per
iteration. Its [..., N, N] matrices grow with N^2; the blocked sweep's
largest temporary is [..., N, B].
"""
from __future__ import annotations

import ctypes
import functools

import torch

from slowfast_vos_tpu_torch.ops import cuda_build
from slowfast_vos_tpu_torch.ops.boxes import box_area, box_iou

NEG_INF = -1e10
FIXPOINT_MAX_N = 6144  # `algorithm="auto"` on the CPU takes the fixpoint up to here
KERNEL_MAX_N = 1 << 16  # K3's per-block column data of a problem stays in a CTA's shared memory
KERNEL_MAX_PROBLEMS = (2**31 - 1) // 16  # problems per launch: a cluster of up to 16 CTAs each in grid.x
SHARED_BUDGET = 224 * 1024  # dynamic shared memory a CTA may take on the shared route (H100: 227 KB a block)
SCRATCH_BUDGET = 1 << 28  # bytes of K3 bitmask per launch on the global route, above which problems go in chunks
BLOCK = 64  # boxes per bitmask word

# K3's launches under "nms", in the counter every kernel wrapper shares.
launches = cuda_build.launches


def sort_desc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Descending sort along the last axis, lower index first among ties
    (`jax.lax.top_k` order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _nms_fixpoint(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS on score-sorted boxes [..., N, 4] by fixpoint iteration:
    keep_{t+1}[i] = valid[i] & !any_{j<i}(keep_t[j] & iou[j,i] > thr)."""
    n = sboxes.shape[-2]
    iou = box_iou(sboxes, sboxes)
    # m[j, i] = (j < i) & overlap: candidate i is suppressed by a kept earlier j.
    earlier = torch.ones((n, n), dtype=torch.bool, device=sboxes.device).triu(1)
    m = (iou > iou_threshold) & earlier & svalid[..., :, None] & svalid[..., None, :]
    keep = svalid
    while True:
        suppressed = (m & keep[..., :, None]).any(dim=-2)
        new_keep = svalid & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def _nms_blocked(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float, block_size: int) -> torch.Tensor:
    """Exact greedy NMS on score-sorted boxes [..., N, 4] as a sweep over
    blocks of `block_size` in score order (JAX `nms.py:96-136`): each block
    is resolved among its boxes still alive (greedy NMS restricted to that
    set, which is what `_nms_fixpoint` computes on the block), then its
    survivors suppress every later box through one [..., N_later, B] IoU.
    The last block is padded with invalid boxes, which are never kept."""
    n = sboxes.shape[-2]
    pad = -n % block_size
    if pad:
        sboxes = torch.cat([sboxes, sboxes.new_zeros((*sboxes.shape[:-2], pad, 4))], dim=-2)
        svalid = torch.cat([svalid, svalid.new_zeros((*svalid.shape[:-1], pad))], dim=-1)
    alive = svalid.clone()
    for lo in range(0, n + pad, block_size):
        hi = lo + block_size
        bboxes = sboxes[..., lo:hi, :]
        block_alive = _nms_fixpoint(bboxes, alive[..., lo:hi], iou_threshold)
        alive[..., lo:hi] = block_alive
        iou = box_iou(sboxes[..., hi:, :], bboxes)  # [..., later, B]
        alive[..., hi:] &= ~((iou > iou_threshold) & block_alive[..., None, :]).any(dim=-1)
    return alive[..., :n]


def pair_overlaps_plain(boxes1: torch.Tensor, boxes2: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """K3's pair test in plain PyTorch: [..., N, M] bool, iou(boxes1[i],
    boxes2[j]) > thr, by the kernel's steps. A pair overlaps when both
    boxes have width and height > 0 and each one's right (bottom) edge lies
    beyond the other's left (top) edge; every other pair takes the
    early-out bit `0 > thr`, since `box_iou` gives it iou 0 (a NaN box
    gives iou 0 on either branch). The overlapping pairs replay `box_iou`'s
    operations (the clamp is the identity there), `fmin`/`fmax` as the
    kernel's `fminf`/`fmaxf`. Equal to `box_iou(boxes1, boxes2) > thr`,
    bit for bit (tests/test_torch_ops.py holds it on edge cases)."""
    a, b = boxes1[..., :, None, :], boxes2[..., None, :, :]

    def wide(x):
        return (x[..., 2] > x[..., 0]) & (x[..., 3] > x[..., 1])

    touch = wide(a) & wide(b) & (a[..., 2] > b[..., 0]) & (b[..., 2] > a[..., 0]) & (a[..., 3] > b[..., 1]) & (
        b[..., 3] > a[..., 1])
    wh = torch.fmin(a[..., 2:], b[..., 2:]) - torch.fmax(a[..., :2], b[..., :2])
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    zero_bit = torch.tensor(0.0, dtype=torch.float32) > iou_threshold
    return torch.where(touch, iou > iou_threshold, zero_bit)


def _check_nms_inputs(boxes: torch.Tensor, eff: torch.Tensor, order: torch.Tensor) -> None:
    """Raise on what K3 does not take: boxes [..., N, 4] contiguous float32,
    16-byte aligned, effective scores [..., N] contiguous float32, float16
    or bfloat16, order [..., N] contiguous int64, all on one device, N <=
    `KERNEL_MAX_N`."""
    if boxes.dtype != torch.float32:
        raise TypeError(f"the NMS kernel takes float32 boxes, got {boxes.dtype}")
    if eff.dtype not in _FLAG_MIN:
        raise TypeError(f"the NMS kernel takes float32, float16 or bfloat16 scores, got {eff.dtype}")
    if order.dtype != torch.int64:
        raise TypeError(f"the NMS kernel takes an int64 order, got {order.dtype}")
    lead = tuple(boxes.shape[:-1])
    if boxes.dim() < 2 or boxes.shape[-1] != 4 or tuple(eff.shape) != lead or tuple(order.shape) != lead:
        raise ValueError(f"boxes must be [..., N, 4], scores and order [..., N], got {tuple(boxes.shape)}, "
                         f"{tuple(eff.shape)} and {tuple(order.shape)}")
    if not (boxes.is_contiguous() and eff.is_contiguous() and order.is_contiguous()):
        raise ValueError("boxes, scores and order must be contiguous")
    if not boxes.device == eff.device == order.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {eff.device}, order on {order.device}: they must share one device")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (one float4 load per box)")
    if boxes.shape[-2] > KERNEL_MAX_N:
        raise ValueError(f"the NMS kernel takes at most {KERNEL_MAX_N} boxes per problem, got {boxes.shape[-2]}")


# The kernel's candidate test `eff > flag_min` in float32 is `score_order`'s
# `eff > NEG_INF / 2` in the scores' dtype: every float16 and bfloat16 value
# and the threshold rounded to that dtype are exact in float32.
_FLAG_MIN = {dt: float(torch.tensor(NEG_INF / 2, dtype=dt)) for dt in (torch.float32, torch.float16, torch.bfloat16)}


@functools.cache
def _library() -> ctypes.CDLL:
    """The library of `csrc/nms.cu`, built at first use, its C interface
    declared."""
    return bind(cuda_build.load("nms.cu"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of `csrc/nms.cu`."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sfvos_nms.argtypes = [vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, ctypes.c_float, vp, ctypes.c_longlong,
                              vp, vp]
    lib.sfvos_nms.restype = ci
    lib.sfvos_nms_prepare.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.sfvos_nms_prepare.restype = ci
    lib.sfvos_nms_shared_bytes.argtypes = [ci, ci, ci]
    lib.sfvos_nms_shared_bytes.restype = ctypes.c_longlong
    lib.sfvos_cuda_error_string.argtypes = [ci]
    lib.sfvos_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cluster_size(n: int) -> int:
    """CTAs in K3's cluster for a problem of `n` boxes: about two 64-box
    blocks a CTA, a power of two from 1 to 16."""
    half = max(1, -(-n // (2 * BLOCK)))
    return min(16, 1 << (half - 1).bit_length())


def shared_bytes(n: int, cluster: int, route: str) -> int:
    """Dynamic shared memory of one K3 CTA (`csrc/nms.cu::layout`): per
    owned block (ceil(W / C) of the W = ceil(n / 64)) its boxes, areas,
    indices, flags, non-empty bits and removed word; per block its kept
    word, flags and mbarrier; on the shared route the owned blocks' words,
    64 W a block."""
    words = -(-n // BLOCK)
    owned = -(-words // cluster)
    total = (16 + 4 + 4) * BLOCK * owned + 3 * 8 * owned + 3 * 8 * words
    return total + (8 * owned * BLOCK * words if route == "shared" else 0)


def route(n: int) -> str:
    """K3's route for `n` boxes: "shared" where a CTA's words fit
    `SHARED_BUDGET` (N <= `SHARED_ROUTE_MAX_N` at the cluster
    `cluster_size` picks), else "global". A function of N alone."""
    return "shared" if shared_bytes(n, cluster_size(n), "shared") <= SHARED_BUDGET else "global"


def scratch_bytes(problems: int, n: int) -> int:
    """K3's device-memory bitmask for `problems` problems of `n` boxes: none
    on the shared route; on the global route the words of every CTA, 64
    W rows of ceil(W / C) blocks, W * 64 W * 8 bytes a problem where C
    divides W (8.4 MB at N = 8192)."""
    if route(n) == "shared":
        return 0
    words, c = -(-n // BLOCK), cluster_size(n)
    return problems * c * -(-words // c) * BLOCK * words * 8


def problems_per_launch(problems: int, n: int) -> int:
    """Problems K3 resolves per launch: all of them on the shared route
    (up to `KERNEL_MAX_PROBLEMS`); on the global route as many as
    `SCRATCH_BUDGET` holds, never fewer than one. A function of the
    shapes."""
    cap = min(problems, KERNEL_MAX_PROBLEMS)
    if route(n) == "shared":
        return cap
    return max(1, min(cap, SCRATCH_BUDGET // scratch_bytes(1, n)))


SHARED_ROUTE_MAX_N = max(n for n in range(BLOCK, KERNEL_MAX_N + 1, BLOCK) if route(n) == "shared")


@functools.cache
def _prepared(lib: ctypes.CDLL, device: int, n: int, cluster: int, global_route: bool) -> int:
    """Let K3's kernel of a route take the card's shared memory and
    clusters of 16, once per library, device and configuration; raise
    unless the card can place a cluster of `cluster` CTAs with the shared
    memory of `n` boxes. Returns how many such clusters it holds at once."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.sfvos_nms_prepare(n, cluster, int(global_route), ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"NMS kernel set-up failed: {lib.sfvos_cuda_error_string(rc).decode()}")
    if count.value < 1:
        raise RuntimeError(f"the card cannot place a cluster of {cluster} NMS CTAs with "
                           f"{lib.sfvos_nms_shared_bytes(n, cluster, int(global_route))} bytes of shared memory each")
    return count.value


def nms_cuda(boxes: torch.Tensor, eff: torch.Tensor, order: torch.Tensor, iou_threshold: float,
             lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """Greedy NMS (K3) on the card: boxes [..., N, 4] and effective scores
    [..., N] in their original order, `order` [..., N] their stable score
    order (`effective_order`); returns keep [..., N] bool over the original
    indices, index-exact with `nms_mask(algorithm="fixpoint")`. A box is a
    candidate iff its effective score > NEG_INF / 2 in the scores' dtype.
    One launch for all problems (every leading dimension flattened) unless
    `problems_per_launch` cuts them into chunks; no host synchronize. The
    threshold goes to the kernel as a float32, as PyTorch compares a
    float32 IoU with it. Raises on what the kernel does not take, where the
    card cannot place its cluster, and on any launch error. With no box it
    returns an empty mask and launches nothing. `lib`: another build of
    `csrc/nms.cu` with the same C interface (default: this checkout's)."""
    _check_nms_inputs(boxes, eff, order)
    if boxes.device.type != "cuda":
        raise ValueError(f"the NMS kernel runs on CUDA tensors, not on {boxes.device}")
    n = boxes.shape[-2]
    keep = torch.empty(eff.shape, dtype=torch.bool, device=eff.device)
    if keep.numel() == 0:  # no problem or no box: nothing to launch
        return keep
    flag_min = _FLAG_MIN[eff.dtype]
    eff = eff if eff.dtype == torch.float32 else eff.float()
    problems = keep.numel() // n
    cluster, global_route = cluster_size(n), route(n) == "global"
    device = boxes.device.index if boxes.device.index is not None else torch.cuda.current_device()
    lib = lib or _library()
    _prepared(lib, device, n, cluster, global_route)
    chunk = problems_per_launch(problems, n)
    nbytes = scratch_bytes(chunk, n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=boxes.device)  # none on the shared route
    ptrs = boxes.data_ptr(), eff.data_ptr(), order.data_ptr(), keep.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, problems, chunk):
            count = min(chunk, problems - start)
            rc = lib.sfvos_nms(ptrs[0] + start * n * 16, ptrs[1] + start * n * 4, ptrs[2] + start * n * 8, count, n,
                               cluster, int(global_route), iou_threshold, flag_min, scratch.data_ptr(), nbytes,
                               ptrs[3] + start * n, stream)
            if rc != 0:
                raise RuntimeError(f"NMS kernel launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
            cuda_build.count_launch("nms", stream)
    return keep


def effective_order(scores: torch.Tensor, valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(eff, order): the scores with NEG_INF where `valid` is off, and the
    score-descending permutation of each problem, invalid entries last,
    lower index first among ties as `jnp.argsort(-scores)`."""
    eff = scores if valid is None else torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    return eff, torch.sort(-eff, dim=-1, stable=True).indices


def score_order(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the plain versions resolve: (order [..., N] from
    `effective_order`; the boxes [..., N, 4] and flags [..., N] gathered
    into it, both contiguous)."""
    eff, order = effective_order(scores, valid)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    return order, sboxes, torch.gather(eff, -1, order) > NEG_INF / 2


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    iou_threshold: float = 0.5,
    block_size: int = 128,
    algorithm: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-maximum suppression with static shapes.

    boxes [..., N, 4] XYXY, scores [..., N], valid optional [..., N] bool
    (invalid entries are never kept). `algorithm`: "auto" (K3 on CUDA
    tensors; on the CPU the fixpoint for N <= `FIXPOINT_MAX_N`, else the
    blocked sweep), "fixpoint" (dense [..., N, N] iteration) or "blocked"
    (the sweep over blocks of `block_size`, bounded memory), the last two
    plain PyTorch on any device; all give the same answer. Returns (keep
    [..., N] bool over the ORIGINAL indices, order [..., N] the
    score-descending permutation)."""
    if algorithm not in ("auto", "fixpoint", "blocked"):
        raise ValueError(f"algorithm must be 'auto', 'fixpoint' or 'blocked', not {algorithm!r}")
    if algorithm == "auto" and boxes.device.type == "cuda":
        eff, order = effective_order(scores, valid)
        boxes = boxes.contiguous()
        if boxes.data_ptr() % 16:  # a view into its storage: the kernel reads a float4 per box
            boxes = boxes.clone()
        return nms_cuda(boxes, eff.contiguous(), order, iou_threshold), order
    if algorithm == "auto" and boxes.device.type != "cpu":
        raise ValueError(f"no NMS for device {boxes.device}: CUDA tensors take the kernel, CPU tensors the plain versions")
    order, sboxes, svalid = score_order(boxes, scores, valid)
    if algorithm == "fixpoint" or (algorithm == "auto" and scores.shape[-1] <= FIXPOINT_MAX_N):
        alive = _nms_fixpoint(sboxes, svalid, iou_threshold)
    else:
        alive = _nms_blocked(sboxes, svalid, iou_threshold, block_size)
    keep = torch.zeros_like(alive).scatter(-1, order, alive)
    return keep, order


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    iou_threshold: float = 0.5,
    block_size: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS via the coordinate-offset trick (torchvision
    `batched_nms`). As in `nms.py:151`, the offset is the maximum over ALL
    boxes of each problem, invalid ones included. `nms_mask`'s "auto" rule
    picks the algorithm (K3 on the card); `block_size` is the blocked
    sweep's."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.amax(dim=(-2, -1)) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[..., None]
    return nms_mask(boxes + offsets[..., None], scores, valid, iou_threshold=iou_threshold, block_size=block_size)


def top_k_after_nms(keep: torch.Tensor, scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Static top-k of kept entries along the last axis, score-descending.
    Returns (indices [..., k], valid [..., k]) into the original index space;
    if fewer than k candidates exist, trailing slots are invalid and point at
    index 0."""
    eff = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    n = eff.shape[-1]
    kk = min(k, n)
    top_scores, top_idx = sort_desc(eff)
    top_scores, top_idx = top_scores[..., :kk], top_idx[..., :kk]
    if kk < k:
        pad = (*eff.shape[:-1], k - kk)
        top_idx = torch.cat([top_idx, top_idx.new_zeros(pad)], dim=-1)
        top_scores = torch.cat([top_scores, top_scores.new_full(pad, NEG_INF)], dim=-1)
    return top_idx, top_scores > NEG_INF / 2
