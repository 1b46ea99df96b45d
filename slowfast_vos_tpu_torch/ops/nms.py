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

`nms_mask(algorithm="auto")`, what every caller passes, sorts by score and
gathers the boxes into that order in PyTorch (as JAX does outside its loop),
resolves the sorted problems, and scatters the result back:

* on CUDA tensors with `nms_cuda`: K3 over every problem of the call at
  once (all leading dimensions flattened, e.g. [frames x FPN levels]), two
  launches (a bitmask kernel and a greedy reduce, see the source's head
  note), no host synchronize, index-exact with the fixpoint. It replaces
  the JAX package's `_nms_fixpoint` and its blocked sweep, which XLA
  computes (there is no Pallas kernel for NMS). Its bound on an H100 is
  float32 operations: ~14 per IoU pair over up to N(N-1)/2 pairs per
  problem, against 18 bytes of input and output per box; its reduce is a
  chain of N greedy steps per problem, spent as ceil(N/64) block steps on
  one SM per problem. Its scratch is P * N * ceil(N/64) * 8 bytes (5.1 MB
  at [40, 1000]); above `SCRATCH_BUDGET` the wrapper launches over chunks
  of problems, sized from the shapes alone.
* on CPU tensors with JAX's rule: the fixpoint up to `FIXPOINT_MAX_N`
  boxes, else the blocked sweep.

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
from slowfast_vos_tpu_torch.ops.boxes import box_iou

NEG_INF = -1e10
FIXPOINT_MAX_N = 6144  # `algorithm="auto"` on the CPU takes the fixpoint up to here
KERNEL_MAX_N = 1 << 17  # K3's removed bitset (N/8 bytes) stays in a CTA's shared memory
KERNEL_MAX_PROBLEMS = 65535  # problems per launch: the mask kernel's grid z extent
SCRATCH_BUDGET = 1 << 28  # bytes of K3 bitmask per launch, above which problems go in chunks

# K3's launch pairs under "nms", in the counter every kernel wrapper shares.
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


def _check_nms_inputs(sboxes: torch.Tensor, svalid: torch.Tensor) -> None:
    """Raise on what K3 does not take: sorted boxes [..., N, 4] contiguous
    float32, 16-byte aligned, flags [..., N] contiguous bool on the same
    device, N <= `KERNEL_MAX_N`."""
    if sboxes.dtype != torch.float32:
        raise TypeError(f"the NMS kernel takes float32 boxes, got {sboxes.dtype}")
    if svalid.dtype != torch.bool:
        raise TypeError(f"the NMS kernel takes bool valid flags, got {svalid.dtype}")
    if sboxes.dim() < 2 or sboxes.shape[-1] != 4 or tuple(svalid.shape) != tuple(sboxes.shape[:-1]):
        raise ValueError(f"boxes must be [..., N, 4] and valid [..., N], got {tuple(sboxes.shape)} and {tuple(svalid.shape)}")
    if not (sboxes.is_contiguous() and svalid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if sboxes.device != svalid.device:
        raise ValueError(f"boxes on {sboxes.device} and valid on {svalid.device}: they must share one device")
    if sboxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (one float4 load per box)")
    if sboxes.shape[-2] > KERNEL_MAX_N:
        raise ValueError(f"the NMS kernel takes at most {KERNEL_MAX_N} boxes per problem, got {sboxes.shape[-2]}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The library of `csrc/nms.cu`, built at first use, its C interface
    declared."""
    lib = cuda_build.load("nms.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sfvos_nms.argtypes = [vp, vp, ci, ci, ctypes.c_float, vp, ctypes.c_longlong, vp, vp]
    lib.sfvos_nms.restype = ci
    lib.sfvos_cuda_error_string.argtypes = [ci]
    lib.sfvos_cuda_error_string.restype = ctypes.c_char_p
    return lib


def scratch_bytes(problems: int, n: int) -> int:
    """K3's bitmask for `problems` problems of `n` boxes: one uint64 per
    (problem, box, 64-box block)."""
    return problems * n * -(-n // 64) * 8


def problems_per_launch(problems: int, n: int) -> int:
    """Problems K3 resolves per launch pair: all of them, unless their
    scratch passes `SCRATCH_BUDGET` or the grid's limit; never fewer than
    one. A function of the shapes."""
    return max(1, min(problems, SCRATCH_BUDGET // scratch_bytes(1, n), KERNEL_MAX_PROBLEMS))


def nms_cuda(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS (K3) of score-sorted boxes [..., N, 4] with flags [..., N]
    on the card: alive [..., N] bool in the same order, index-exact with
    `_nms_fixpoint`. One launch pair for all problems (every leading
    dimension flattened) unless `problems_per_launch` cuts them into
    chunks; no host synchronize. The threshold goes to the kernel as a
    float32, as PyTorch compares a float32 IoU with it. Raises on what the
    kernel does not take and on any launch error. With no box it returns
    an empty mask and launches nothing."""
    _check_nms_inputs(sboxes, svalid)
    if sboxes.device.type != "cuda":
        raise ValueError(f"the NMS kernel runs on CUDA tensors, not on {sboxes.device}")
    n = sboxes.shape[-2]
    alive = torch.empty(svalid.shape, dtype=torch.bool, device=svalid.device)
    if alive.numel() == 0:  # no problem or no box: nothing to launch
        return alive
    problems = alive.numel() // n
    lib = _library()
    chunk = problems_per_launch(problems, n)
    nbytes = scratch_bytes(chunk, n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=svalid.device)
    boxes_ptr, valid_ptr, alive_ptr = sboxes.data_ptr(), svalid.data_ptr(), alive.data_ptr()
    with torch.cuda.device(svalid.device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, problems, chunk):
            count = min(chunk, problems - start)
            rc = lib.sfvos_nms(boxes_ptr + start * n * 16, valid_ptr + start * n, count, n, iou_threshold,
                               scratch.data_ptr(), nbytes, alive_ptr + start * n, stream)
            if rc != 0:
                raise RuntimeError(f"NMS kernel launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
            cuda_build.count_launch("nms")
    return alive


def score_order(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What `nms_mask` resolves: (order [..., N], the score-descending
    permutation with invalid entries last, lower index first among ties as
    `jnp.argsort(-scores)`; the boxes [..., N, 4] and flags [..., N]
    gathered into it, both contiguous)."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    eff = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-eff, dim=-1, stable=True).indices
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
    order, sboxes, svalid = score_order(boxes, scores, valid)
    n = scores.shape[-1]
    if algorithm == "auto" and boxes.device.type == "cuda":
        alive = nms_cuda(sboxes, svalid, iou_threshold)
    elif algorithm == "auto" and boxes.device.type != "cpu":
        raise ValueError(f"no NMS for device {boxes.device}: CUDA tensors take the kernel, CPU tensors the plain versions")
    elif algorithm == "fixpoint" or (algorithm == "auto" and n <= FIXPOINT_MAX_N):
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
