"""The PyTorch port's checks that need the card: the RoIAlign kernel and
its backward against their plain versions, the level assignment on the
card against the CPU's, the YUV 4:2:0 decode on the card against the CPU's,
the blocked NMS sweep on the card against the fixpoint, the NMS kernel
(K3) against the fixpoint, index for index, the superchunk's CUDA
graphs (`models/graphs.py`) against the eager path, bit for bit, the
training step's (`train/graphs.py`) likewise, their stage marks under the
tracer (`utils/profiling.py`), and K6, SlowFast's train-mode BatchNorm
(`ops/batch_norm.py`), against its plain versions, and K7, ViTDet's
attention with decomposed relative positions (`ops/attention.py`), against
its plain version, with ViTDet-B's pipeline on its graphs, and K8, the
backbone's convolution epilogue (`ops/conv_epilogue.py`), against its plain
version, through its autograd Function, and in the folded backbone.
Imports neither JAX's models nor flax, so it runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q

Every test is marked `cuda` and skips where CUDA is absent."""
import copy

import numpy as np
import pytest
import torch

from torch_roi_cases import boundary_rois, clustered_batch, cuda_device, edge_case_batch  # noqa: F401 (fixture)
from slowfast_vos_tpu_torch.models.pipeline import Pipeline, build_pipeline, frame_detections, init_weights
from slowfast_vos_tpu_torch.models.slowfast import (
    batch_norm_normalize, batch_norm_train_backward_plain, batch_norm_train_plain,
)
from slowfast_vos_tpu_torch.models.transform import ImageTransform
from slowfast_vos_tpu_torch.ops import attention as patt
from slowfast_vos_tpu_torch.ops import batch_norm as pbn
from slowfast_vos_tpu_torch.ops import conv_epilogue as pce
from slowfast_vos_tpu_torch.ops import nms as pnms
from slowfast_vos_tpu_torch.ops import roi_align as pra
from slowfast_vos_tpu_torch import data
from slowfast_vos_tpu_torch.train import Trainer
from slowfast_vos_tpu_torch.train.pretrain import warmup_step_lr
from slowfast_vos_tpu_torch.utils.profiling import TRACER


@pytest.mark.cuda
@pytest.mark.parametrize("c", [40, 256])
def test_cuda_kernel_matches_plain_version(cuda_device, c):
    """On the card, on the edge-case rois: the kernel against its plain
    version, f32 (TF32 off) atol 1e-5 + rtol 1e-5, bf16 against the plain
    version in f32 on the same bf16 inputs within one bf16 rounding (rtol
    2^-8). 256 channels are whole channel slices at both pools; 40 leave a
    partial slice, and in f32 a partial one of 16-byte vectors."""
    rng = np.random.default_rng(4)
    feats, rois = edge_case_batch(rng, 3, c=c)
    feats = [torch.from_numpy(f).to(cuda_device) for f in feats]
    rois = torch.from_numpy(rois).to(cuda_device)
    for out_size in (7, 14):
        before = pra.launches[out_size]
        got = pra.multiscale_roi_align(feats, rois, output_size=out_size)
        assert pra.launches[out_size] == before + 1
        want = pra.multiscale_roi_align_plain(feats, rois, output_size=out_size)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        f16 = [f.bfloat16() for f in feats]
        got = pra.multiscale_roi_align(f16, rois, output_size=out_size).float()
        want = pra.multiscale_roi_align_plain([f.float() for f in f16], rois, output_size=out_size)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=2.0**-8)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [40, 256])
def test_cuda_backward_kernel_matches_plain_version(cuda_device, c):
    """On the card, on the edge-case rois: the backward kernel (K5) through
    the autograd pool against the plain backward, per pixel within
    1e-6 + 1e-5 B in f32 (TF32 off) and 1e-6 + 2^-8 B in bf16, where B is
    the plain backward of |g| (the sum of the contributions' magnitudes:
    the kernel adds them in a fixed order, but not in the plain
    version's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    feats, rois = edge_case_batch(rng, 2, c=c)
    rois = torch.from_numpy(rois).to(cuda_device)
    hws = [f.shape[1:3] for f in feats]
    for out_size in (7, 14):
        g = torch.from_numpy(rng.normal(size=(*rois.shape[:2], out_size, out_size, c)).astype(np.float32)).to(cuda_device)
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-8)):
            levels = [torch.from_numpy(f).to(cuda_device, dtype).requires_grad_(True) for f in feats]
            gd = g.to(dtype)
            before = pra.launches["backward", out_size]
            pooled = pra.multiscale_roi_align(levels, rois, output_size=out_size)
            got = torch.autograd.grad(pooled, levels, gd)
            assert pra.launches["backward", out_size] == before + 1
            want = pra.multiscale_roi_align_backward_plain(gd.float(), rois, hws, output_size=out_size)
            bound = pra.multiscale_roi_align_backward_plain(gd.float().abs(), rois, hws, output_size=out_size)
            for gl, wl, bl in zip(got, want, bound):
                assert gl.dtype == dtype and gl.shape == wl.shape
                assert bool(((gl.float() - wl).abs() <= 1e-6 + rtol * bl).all()), (out_size, dtype)


def _backward_inputs(cuda_device, rng, feats, rois, out_size):
    rois = torch.from_numpy(rois).to(cuda_device)
    g = rng.normal(size=(*rois.shape[:2], out_size, out_size, feats[0].shape[-1])).astype(np.float32)
    return rois, torch.from_numpy(g).to(cuda_device), [f.shape[1:3] for f in feats]


@pytest.mark.cuda
@pytest.mark.parametrize("out_size", [7, 14])
def test_cuda_backward_kernel_is_deterministic(cuda_device, out_size):
    """Two backward calls on the same inputs give the same bits, f32 and
    bf16: every gradient pixel sums its rois' contributions in one fixed
    order. On the clustered batch, where most rois overlap."""
    rng = np.random.default_rng(6)
    feats, rois = clustered_batch(rng, 2, c=64)
    rois, g, hws = _backward_inputs(cuda_device, rng, feats, rois, out_size)
    for dtype in (torch.float32, torch.bfloat16):
        first = pra.roi_align_backward_cuda(g.to(dtype), rois, hws, output_size=out_size)
        second = pra.roi_align_backward_cuda(g.to(dtype), rois, hws, output_size=out_size)
        assert all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(first, second)), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("c", [40, 256])
def test_cuda_backward_kernel_matches_plain_on_clustered_rois(cuda_device, c):
    """On the card, 200 rois jittered around one object, the whole-level P5
    roi and the edge cases: the backward kernel against the plain backward
    per pixel within 1e-6 + rtol B (B the plain backward of |g|), rtol 1e-5
    in f32 (TF32 off) and 2^-8 in bf16, at both pools. 40 channels leave a
    partial channel slice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    feats, rois = clustered_batch(rng, 2, c=c)
    for out_size in (7, 14):
        rois_t, g, hws = _backward_inputs(cuda_device, rng, feats, rois, out_size)
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-8)):
            gd = g.to(dtype)
            got = pra.roi_align_backward_cuda(gd, rois_t, hws, output_size=out_size)
            want = pra.multiscale_roi_align_backward_plain(gd.float(), rois_t, hws, output_size=out_size)
            bound = pra.multiscale_roi_align_backward_plain(gd.float().abs(), rois_t, hws, output_size=out_size)
            for gl, wl, bl in zip(got, want, bound):
                assert gl.dtype == dtype and gl.shape == wl.shape
                assert bool(((gl.float() - wl).abs() <= 1e-6 + rtol * bl).all()), (out_size, dtype)


@pytest.mark.cuda
def test_cuda_backward_kernel_all_invalid_rois_give_zero(cuda_device):
    """Rois whose samples all fall outside [-1, H] (above, left of, and
    beyond the canvas, on every level) add nothing: the gradient is exactly
    zero, f32 and bf16, at both pools."""
    rng = np.random.default_rng(8)
    feats, _ = edge_case_batch(rng, 2, c=16)
    boxes = np.array([[-900.0, -900.0, -500.0, -500.0], [-2000.0, 10.0, -1200.0, 900.0],
                      [1300.0, 1100.0, 1900.0, 1500.0], [10.0, 1300.0, 20.0, 1310.0], [-100.0, -100.0, -60.0, -60.0]])
    rois = np.broadcast_to(boxes, (2, *boxes.shape)).astype(np.float32).copy()
    for out_size in (7, 14):
        rois_t, g, hws = _backward_inputs(cuda_device, rng, feats, rois, out_size)
        for dtype in (torch.float32, torch.bfloat16):
            got = pra.roi_align_backward_cuda(g.to(dtype), rois_t, hws, output_size=out_size)
            assert all(gl.dtype == dtype and not gl.any() for gl in got), (out_size, dtype)


@pytest.mark.cuda
def test_level_assignment_on_the_card_matches_cpu(cuda_device):
    """At the level boundaries the card must divide as the CPU does."""
    rois = boundary_rois()
    torch.testing.assert_close(pra.fpn_level_assignment(rois.to(cuda_device)).cpu(), pra.fpn_level_assignment(rois))


@pytest.mark.cuda
def test_blocked_nms_on_the_card_matches_fixpoint(cuda_device):
    """Blocked sweep (B = 128, a ragged last block) on the card against the
    fixpoint on the card and on the CPU, index for index, on quantized
    boxes and scores (ties across block boundaries), two problems."""
    rng = np.random.default_rng(8)
    n = 1500
    xy = rng.uniform(0, 400, (2, n, 2))
    boxes = np.round(np.concatenate([xy, xy + rng.uniform(4, 80, (2, n, 2))], -1) / 8) * 8
    boxes = torch.from_numpy(boxes.astype(np.float32))
    scores = torch.from_numpy((np.round(rng.uniform(0, 1, (2, n)) * 16) / 16).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(2, n)) > 0.1)
    want = pnms.nms_mask(boxes, scores, valid, iou_threshold=0.7, algorithm="fixpoint")
    on_card = [b.to(cuda_device) for b in (boxes, scores, valid)]
    for algorithm in ("blocked", "fixpoint"):
        keep, order = pnms.nms_mask(*on_card, iou_threshold=0.7, algorithm=algorithm)
        assert torch.equal(order.cpu(), want[1]) and torch.equal(keep.cpu(), want[0]), algorithm


def nms_case(rng, lead, n, canvas=(768, 1344), quantum=8.0, scale=(8, 300)):
    """Quantized boxes on the canvas [*lead, n, 4] and scores [*lead, n] in
    steps of 1/16 (duplicate boxes, equal scores and IoUs exactly at the
    threshold), 10% of the flags invalid, as CPU tensors."""
    xy = rng.uniform(0, [canvas[1], canvas[0]], (*lead, n, 2))
    boxes = np.round(np.concatenate([xy, xy + rng.uniform(*scale, (*lead, n, 2))], -1) / quantum) * quantum
    scores = np.round(rng.uniform(0, 1, (*lead, n)) * 16) / 16
    return (torch.from_numpy(boxes.astype(np.float32)), torch.from_numpy(scores.astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(*lead, n)) > 0.1))


def assert_kernel_matches_fixpoint(device, boxes, scores, valid, thr):
    """K3 (`nms_mask`'s "auto" on the card) against the fixpoint on the card
    and on the CPU: keep and order index for index, one launch."""
    on_card = [None if x is None else x.to(device) for x in (boxes, scores, valid)]
    before = pnms.launches["nms"]
    keep, order = pnms.nms_mask(*on_card, iou_threshold=thr)
    assert pnms.launches["nms"] == before + 1
    fixpoint = pnms.nms_mask(*on_card, iou_threshold=thr, algorithm="fixpoint")
    cpu = pnms.nms_mask(boxes, scores, valid, iou_threshold=thr, algorithm="fixpoint")
    for want in (fixpoint, cpu):
        assert torch.equal(order.cpu(), want[1].cpu()) and torch.equal(keep.cpu(), want[0].cpu())
    return keep.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,thr", [
    ((8, 5), 1000, 0.7),  # RPN `filter_proposals`, inference at superchunk 8 (cluster of 8)
    ((2, 5), 2000, 0.7),  # RPN `filter_proposals`, one train step (cluster of 16)
    ((3,), 1, 0.5), ((3,), 63, 0.5), ((3,), 64, 0.5), ((3,), 65, 0.5),  # one block, full and ragged
    ((3,), 127, 0.5), ((3,), 128, 0.5), ((3,), 129, 0.5),  # two blocks; three, the first cluster of 2
    ((3,), 257, 0.5), ((3,), 513, 0.5), ((3,), 1025, 0.5),  # the first clusters of 4, 8 and 16
    ((2,), 5120, 0.5), ((2,), 5121, 0.5),  # the last N of the shared route, the first of the global one
    ((1,), 8192, 0.5),  # phase 10's large case (global route)
])
def test_nms_kernel_matches_fixpoint(cuda_device, lead, n, thr):
    """K3 at the main path's shapes, at block edges, at every cluster size
    the wrapper picks and at the route boundary, on quantized boxes and
    scores (ties, IoUs exactly at the threshold), index-exact."""
    keep = assert_kernel_matches_fixpoint(cuda_device, *nms_case(np.random.default_rng(n), lead, n), thr)
    assert n < 64 or 0 < keep.sum() < keep.numel()


@pytest.mark.cuda
def test_nms_kernel_class_keyed_matches_fixpoint(cuda_device):
    """`postprocess_detections`' class-keyed call through `batched_nms_mask`
    ([8, 1000]: 1000 proposals x 1 foreground class, plus a second label on
    half of them, 0.5): the kernel sees the offset boxes, as the fixpoint."""
    boxes, scores, valid = nms_case(np.random.default_rng(21), (8,), 1000)
    labels = torch.from_numpy(np.random.default_rng(22).integers(1, 3, (8, 1000)).astype(np.int32))
    on_card = [x.to(cuda_device) for x in (boxes, scores, labels, valid)]
    before = pnms.launches["nms"]
    keep, order = pnms.batched_nms_mask(*on_card, iou_threshold=0.5)
    assert pnms.launches["nms"] == before + 1
    want = pnms.batched_nms_mask(boxes, scores, labels, valid, iou_threshold=0.5)
    assert torch.equal(order.cpu(), want[1]) and torch.equal(keep.cpu(), want[0])


@pytest.mark.cuda
def test_nms_kernel_edge_cases(cuda_device):
    """Problems side by side in one call: all invalid; half invalid;
    zero-area boxes (union 0: IoU 0, never suppressed, never suppressing);
    identical boxes (the first valid one kept); boxes touching at an edge
    (intersection 0); a box inside another at IoU exactly 0.5."""
    rng = np.random.default_rng(23)
    n = 130
    boxes, scores, valid = nms_case(rng, (6,), n, canvas=(200, 200), quantum=4.0, scale=(4, 60))
    valid[0] = False
    valid[1, ::2] = False
    boxes[2, ::3, 2:] = boxes[2, ::3, :2]  # zero area
    boxes[2, 1::3, 2] = boxes[2, 1::3, 0]  # zero width
    boxes[3] = torch.tensor([10.0, 10.0, 50.0, 50.0])  # identical
    boxes[4, :, :2] = torch.arange(n, dtype=torch.float32)[:, None] * 10  # a chain touching at edges
    boxes[4, :, 2:] = boxes[4, :, :2] + 10
    boxes[5, :2] = torch.tensor([[0.0, 0.0, 20.0, 20.0], [0.0, 0.0, 20.0, 10.0]])  # IoU 0.5 exactly
    scores[5, :2] = torch.tensor([2.0, 1.5])
    valid[5, :2] = True
    keep = assert_kernel_matches_fixpoint(cuda_device, boxes, scores, valid, 0.5)
    assert not keep[0].any() and not keep[1, ::2].any()
    assert keep[3].sum() == 1 and torch.equal(keep[4], valid[4]) and keep[5, 0] and keep[5, 1]


@pytest.mark.cuda
def test_nms_kernel_batched_equals_per_problem_and_repeats_bitwise(cuda_device):
    """One launch over [2, 5, 2000] equals a launch per problem and the
    fixpoint; two calls give the same bits."""
    boxes, scores, valid = (x.to(cuda_device) for x in nms_case(np.random.default_rng(24), (2, 5), 2000))
    eff, order = pnms.effective_order(scores, valid)
    keep = pnms.nms_cuda(boxes, eff, order, 0.7)
    for i in range(2):
        for j in range(5):
            one = pnms.nms_cuda(boxes[i, j].contiguous(), eff[i, j].contiguous(), order[i, j].contiguous(), 0.7)
            assert torch.equal(one, keep[i, j])
    assert torch.equal(pnms.nms_cuda(boxes, eff, order, 0.7), keep)
    assert torch.equal(keep, pnms.nms_mask(boxes, scores, valid, iou_threshold=0.7, algorithm="fixpoint")[0])


@pytest.mark.cuda
def test_nms_kernel_global_route_in_forced_chunks(cuda_device, monkeypatch):
    """The global route (N = 5121, bitmask in device memory) with a scratch
    budget of two problems: chunks of 2, 2, 1, one launch each, the same
    bits as one launch and as the fixpoint."""
    boxes, scores, valid = (x.to(cuda_device) for x in nms_case(np.random.default_rng(26), (5,), 5121))
    eff, order = pnms.effective_order(scores, valid)
    assert pnms.route(5121) == "global"
    whole = pnms.nms_cuda(boxes, eff, order, 0.5)
    monkeypatch.setattr(pnms, "SCRATCH_BUDGET", 2 * pnms.scratch_bytes(1, 5121))
    before = pnms.launches["nms"]
    chunked = pnms.nms_cuda(boxes, eff, order, 0.5)
    assert pnms.launches["nms"] == before + 3
    assert torch.equal(chunked, whole)
    assert torch.equal(whole, pnms.nms_mask(boxes, scores, valid, iou_threshold=0.5, algorithm="fixpoint")[0])


@pytest.mark.cuda
def test_nms_kernel_score_edge_cases(cuda_device):
    """The kernel's candidate test against `score_order`'s: scores at and
    next to NEG_INF / 2, NaN and +-inf scores, no `valid` at all, and
    bfloat16 and float16 scores (cast to float32 for the kernel, with the
    threshold of their own dtype; float16 without flags, as NEG_INF
    overflows it); all invalid keeps nothing."""
    boxes, scores, valid = nms_case(np.random.default_rng(27), (4,), 300)
    base = torch.tensor(pnms.NEG_INF / 2, dtype=torch.float32)
    scores[0, :30] = base
    scores[0, 30:60] = torch.nextafter(base, torch.tensor(0.0))
    scores[0, 60:90] = torch.nextafter(base, torch.tensor(-1.0))
    scores[1, ::7] = float("nan")
    scores[1, 1::7] = float("inf")
    scores[2, ::5] = -float("inf")
    valid[3] = False
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        s = scores.to(dtype)
        for v in (valid, None) if dtype != torch.float16 else (None,):  # NEG_INF overflows float16
            keep = assert_kernel_matches_fixpoint(cuda_device, boxes, s, v, 0.5)
            if v is not None:
                assert not keep[3].any()


@pytest.mark.cuda
def test_nms_kernel_layout_and_cluster_refusal(cuda_device, monkeypatch):
    """The wrapper's shared-memory sizes are the kernel's own
    (`sfvos_nms_shared_bytes`); a configuration the card cannot place (the
    shared route forced at 8192 boxes: 0.5 MB a CTA) raises, before any
    launch, and falls back to nothing."""
    lib = pnms._library()
    for n in (1, 65, 129, 1000, 2000, 5120, 5121, 8192, pnms.KERNEL_MAX_N):
        for c in (1, 2, 4, 8, 16):
            for route in ("shared", "global"):
                assert lib.sfvos_nms_shared_bytes(n, c, int(route == "global")) == pnms.shared_bytes(n, c, route)
    monkeypatch.setattr(pnms, "SHARED_BUDGET", 1 << 30)
    boxes, scores, valid = (x.to(cuda_device) for x in nms_case(np.random.default_rng(28), (1,), 8192))
    before = pnms.launches["nms"]
    with pytest.raises(RuntimeError, match="cannot place a cluster|set-up failed"):
        pnms.nms_mask(boxes, scores, valid, iou_threshold=0.5)
    assert pnms.launches["nms"] == before


@pytest.mark.cuda
def test_nms_kernel_path_has_no_host_synchronize(cuda_device):
    """`nms_mask`'s K3 path (the effective scores, their sort, the kernel)
    under the sync debug mode "error", which raises on any synchronizing
    call, on both routes; and no box at all launches nothing."""
    boxes, scores, valid = (x.to(cuda_device) for x in nms_case(np.random.default_rng(25), (8, 5), 1000))
    large = [x.to(cuda_device) for x in nms_case(np.random.default_rng(29), (1,), 8192)]
    pnms.nms_mask(*large, iou_threshold=0.5)  # builds and prepares outside the checked region
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keep, _ = pnms.nms_mask(boxes, scores, valid, iou_threshold=0.7)
        large_keep, _ = pnms.nms_mask(*large, iou_threshold=0.5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert keep.shape == (8, 5, 1000) and large_keep.shape == (1, 8192)
    before = pnms.launches["nms"]
    keep, order = pnms.nms_mask(boxes[:, :, :0], scores[:, :, :0], valid[:, :, :0], iou_threshold=0.7)
    assert keep.shape == (8, 5, 0) and pnms.launches["nms"] == before


# The superchunk's CUDA graphs: (original size, resize bounds, dtype,
# superchunk, frames): the `__graft_entry__` size in f32 and DAVIS 480p in
# bf16, each over a first, a carry and a ragged carry chunk.
GRAPH_SIZES = {
    "small": ((120, 200), dict(min_size=128, max_size=256), torch.float32, 4, 10),
    "full": ((480, 854), {}, torch.bfloat16, 8, 20),
}


def graph_and_eager(size, seed=0):
    """A pipeline on the card with its graphs and an eager one over the same
    model, seeded weights, and the size's clip."""
    hw, bounds, dtype, sc, frames = GRAPH_SIZES[size]
    pipe, model = build_pipeline(3, 3, hw, dtype=dtype, device="cuda", superchunk=sc, **bounds)
    init_weights(model, seed)
    eager = Pipeline(model, pipe.transform, superchunk=sc, graphs=False)
    clip = np.random.default_rng(seed + 1).integers(0, 256, (frames, *hw, 3), dtype=np.uint8)
    return pipe, eager, clip


def assert_same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("instance_masks", [False, True])
@pytest.mark.parametrize("size", ["small", "full"])
def test_graph_path_equals_eager_bit_for_bit(cuda_device, size, instance_masks):
    """`infer_sequence` through the graphs (the first run: each key's first
    chunk eager, then replays; the second run: replays only) against the
    eager path on the same model: every output equal bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe, eager, clip = graph_and_eager(size)
    want = eager.infer_sequence(clip, instance_masks=instance_masks)
    assert any(d["valid"].any() for d in want)
    for _ in range(2):
        assert_same_detections(pipe.infer_sequence(clip, instance_masks=instance_masks), want)
    assert pipe.graphs.captures == 2 and len(pipe.graphs.graphs) == 2  # first and carry


@pytest.mark.cuda
def test_graph_replays_in_place_weight_updates_and_recaptures_moved_ones(cuda_device):
    """Other weights loaded in place after capture are what a replay
    computes with (no new capture); a replaced parameter drops the graphs,
    and the next run captures anew."""
    pipe, eager, clip = graph_and_eager("small")
    pipe.infer_sequence(clip)
    assert pipe.graphs.captures == 2
    _, other = build_pipeline(3, 3, (120, 200), min_size=128, max_size=256, dtype=torch.float32, device="cuda",
                              superchunk=4)
    pipe.model.load_state_dict(init_weights(other, 5).state_dict())
    assert_same_detections(pipe.infer_sequence(clip), eager.infer_sequence(clip))
    assert pipe.graphs.captures == 2
    head = pipe.model.roi_heads.box_predictor.cls_score
    head.weight = torch.nn.Parameter(head.weight.detach() * 2)
    assert_same_detections(pipe.infer_sequence(clip), eager.infer_sequence(clip))
    assert pipe.graphs.captures == 4
    pipe.model.train()
    with pytest.raises(RuntimeError, match="eval mode"):
        pipe.infer_sequence(clip)
    pipe.model.eval()


@pytest.mark.cuda
def test_graph_path_has_no_host_synchronize(cuda_device):
    """After a first run has captured the graphs, the host's part of a run
    (staging, uploads, copies into the static inputs, replays, clones)
    under the sync debug mode "error"; only the final fetch waits."""
    pipe, eager, clip = graph_and_eager("small")
    want = eager.infer_sequence(clip)
    pipe.infer_sequence(clip)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pipe.infer_chunks(clip)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_same_detections(frame_detections(pending, clip.shape[0], clip.shape[2]), want)


# K8 launches of one ResNet-50 + FPN forward: the stem, 16 blocks x 3, 4 downsamples, 8 FPN convolutions.
K8_PER_BACKBONE = 61


@pytest.mark.cuda
def test_graph_replays_count_their_kernel_launches(cuda_device):
    """A replay adds the K1 (7, 14) and K3 launches its graph recorded at
    capture: a warm run counts what the eager path counts, one launch of
    each pool and two of K3 per superchunk; capture itself counts none.
    A graph also records K8 once a backbone convolution."""
    pipe, eager, clip = graph_and_eager("small")
    chunks = -(-clip.shape[0] // pipe.superchunk)
    counts = []
    for p in (eager, pipe, pipe):
        before = {k: pra.launches[k] for k in (7, 14, "nms")}
        p.infer_sequence(clip)
        counts.append({k: pra.launches[k] - v for k, v in before.items()})
    assert counts == [{7: chunks, 14: chunks, "nms": 2 * chunks}] * 3
    for captured in pipe.graphs.graphs.values():
        assert captured.launches == {7: 1, 14: 1, "nms": 2, "epilogue": K8_PER_BACKBONE}


# The training step's CUDA graphs, at the `__graft_entry__` size in f32
# (TF32 off), default DetectionConfig: (Trainer arguments, second canvas).
TRAIN_HW, SECOND_HW = (120, 200), (160, 160)  # canvases 128x256 and 128x128
TRAIN_CASES = {
    "accumulate 1": (dict(), False),
    "accumulate 2": (dict(accumulate=2, n_center=1), False),
    "freeze none": (dict(train_backbone=True, train_slow_fast=True), False),
    "freeze SF": (dict(train_backbone=True, train_slow_fast=False), False),
    "freeze BB_SF": (dict(train_backbone=False, train_slow_fast=False), False),
    "backbone with a schedule": (dict(train_backbone=True, trainable_backbone_layers=3,
                                      lr=warmup_step_lr(1e-3, 4, warmup_iters=3)), False),
    "two canvases": (dict(train_backbone=True, trainable_backbone_layers=3), True),
}
TRAIN_KEYS = (7, 14, ("backward", 7), ("backward", 14), "nms")


def train_setup(n_center=2, second=False):
    """Pipelines on the card over one seeded model (a second canvas if
    asked) and 8 calls' windows of seeded moving blobs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe, model = build_pipeline(3, 3, TRAIN_HW, dtype=torch.float32, device="cuda", superchunk=4,
                                 min_size=128, max_size=256)
    init_weights(model, 0)
    pipes = [pipe]
    if second:
        pipes.append(Pipeline(model, ImageTransform(SECOND_HW, min_size=128, max_size=256), superchunk=4))
    calls = []
    for k in range(8):
        p = pipes[k % len(pipes)]
        images, ids = data.draw_sequence(np.random.default_rng(k % len(pipes)), 6, *p.transform.original_hw, 2)
        wins = list(data.train_windows(data.sequence_arrays(images, ids, p.cfg.max_gt), fast=3, n_center=n_center))
        calls.append((p, wins[k // len(pipes) % len(wins)]))
    return pipes, calls


def train_run(pipes, calls, start, graphs, **kw):
    """The calls of a fresh trainer from the model state `start`: after each,
    the metrics, the gradients before the update, the weights after it, the
    running statistics and the generator's state."""
    model = pipes[0].model
    model.load_state_dict(start)
    tr = Trainer(pipes[0], graphs=graphs, seed=3, **kw)
    out = []
    for p, batch in calls:
        tr.use_pipeline(p)
        metrics = tr.accumulate_gradient(batch)
        grads = [x.grad.clone() for x in tr.params.values()]
        if tr.calls % tr.accumulate == 0:
            tr.apply_update()
        out.append([*(metrics[k] for k in sorted(metrics)), *grads, *(v.clone() for v in model.state_dict().values()),
                    tr.generator.get_state()])
    return out, tr


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_graphs_equal_eager_steps_bit_for_bit(cuda_device, case):
    """8 calls on the step graphs (each key's first call eager, then
    captured, then replays) against 8 eager calls from the same state and
    seed: losses, gradients, every weight and running statistic after each
    update and the generator's state, bit for bit. At this size in f32
    cuDNN's default choice of weight-gradient algorithm is not
    reproducible (two eager runs differ by ~1e-8 in some gradients at the
    first call), so the runs pin its deterministic algorithms, and two
    eager runs are first held equal to each other."""
    kw, second = TRAIN_CASES[case]
    pipes, calls = train_setup(kw.get("n_center", 2), second)
    start = {k: v.clone() for k, v in pipes[0].model.state_dict().items()}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        want, _ = train_run(pipes, calls, start, False, **kw)
        again, _ = train_run(pipes, calls, start, False, **kw)
        got, tr = train_run(pipes, calls, start, True, **kw)
    assert tr.graphs.captures == len(pipes) + 1 and len(tr.graphs.graphs) == len(pipes)
    for k, (g, a, w) in enumerate(zip(got, again, want)):
        assert all(torch.equal(x, y) for x, y in zip(a, w)), f"two eager runs differ at call {k}"
        assert all(torch.equal(x, y) for x, y in zip(g, w)), f"call {k}"
    assert not all(torch.equal(v, start[k]) for k, v in pipes[0].model.state_dict().items())


@pytest.mark.cuda
def test_train_step_has_no_host_synchronize(cuda_device):
    """A warm step, its batch staged and uploaded from host arrays, on
    either path under the sync debug mode "error"."""
    pipes, calls = train_setup()
    tr = Trainer(pipes[0])
    runner, batch = tr.graphs, calls[1][1]
    for graphs in (None, runner, None, runner):
        tr.graphs = graphs
        tr.step(batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = tr.step(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.cuda
def test_train_graph_replays_count_their_kernel_launches(cuda_device):
    """Each gradient graph records one launch of K1 and K5 at both pools,
    one of K3, 32 of K6's forward and backward (the backward's from
    autograd's thread too) and K8 once a backbone convolution, the update
    graph none; a replayed step counts what an eager step counts."""
    pipes, calls = train_setup()
    tr = Trainer(pipes[0])
    runner, batch = tr.graphs, calls[1][1]
    counts = []
    for graphs in (None, runner, runner, runner):
        tr.graphs = graphs
        before = {k: pra.launches[k] for k in TRAIN_KEYS}
        tr.step(batch)
        counts.append({k: pra.launches[k] - v for k, v in before.items()})
    assert counts == [{k: 1 for k in TRAIN_KEYS}] * 4
    # K6: 8 BatchNorms x 4 FPN levels, forward and backward.
    assert [c.launches for c in runner.graphs.values()] == [
        {**{k: 1 for k in TRAIN_KEYS}, "bn": 32, ("backward", "bn"): 32, "epilogue": K8_PER_BACKBONE}]
    assert runner.update.launches == {}


@pytest.fixture
def traced():
    """The port's tracer on, from empty; off and empty afterwards."""
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.take()


INFER_STAGES = ["transform", "backbone", "rpn", "slowfast", "roi_heads", "finalize"]


@pytest.mark.cuda
def test_stage_marks_in_a_graph_are_read_without_a_synchronize(cuda_device, traced):
    """With the tracer on, the superchunk graphs are captured anew with
    their stage marks as event nodes: the same launches per replay as the
    untraced graphs, and the same detections as the eager path. A replay
    bracketed by two events on the stream: its stage times sum to nearly
    their span, and no more. A warm run, under the sync debug mode
    "error", reads the replays that have finished before each replay; the
    rest are read or counted unread at `take()`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe, eager, clip = graph_and_eager("small")
    want = eager.infer_sequence(clip)
    traced.disable()
    pipe.infer_sequence(clip)
    untraced = {key[:-1]: g.launches for key, g in pipe.graphs.graphs.items()}
    traced.enable()
    assert_same_detections(pipe.infer_sequence(clip), want)
    assert pipe.graphs.captures == 4
    marked = {key[:-1]: g for key, g in pipe.graphs.graphs.items() if key[-1]}
    assert {k: g.launches for k, g in marked.items()} == untraced
    assert all([name for name, _ in g.clock.events] == ["", *INFER_STAGES] for g in marked.values())
    torch.cuda.synchronize()
    traced.take()

    images, valid = pipe.chunk_inputs(clip, 0, False)
    pipe._run(images, valid)  # the first chunk's graph has not been replayed yet: its first launch uploads it
    torch.cuda.synchronize()
    traced.take()
    before, after = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the card busy meanwhile: the bracket holds no host time
    before.record()
    pipe._run(images, valid)
    after.record()
    torch.cuda.synchronize()
    (label, stages), = traced.take()["stages"].items()
    assert label.startswith("superchunk.first") and (stages["replays"], stages["samples"]) == (1, 1)
    assert sorted(stages["ms"]) == sorted(INFER_STAGES) and all(v > 0 for v in stages["ms"].values())
    span = before.elapsed_time(after)
    assert 0.9 * span <= sum(stages["ms"].values()) <= span

    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pipe.infer_chunks(clip)
        pending += pipe.infer_chunks(clip)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_same_detections(frame_detections(pending[len(pending) // 2:], clip.shape[0], clip.shape[2]), want)
    snap = traced.take()
    chunks = -(-clip.shape[0] // pipe.superchunk)
    assert sum(st["replays"] for st in snap["stages"].values()) == 2 * chunks == snap["totals"]["graphs.replay"]["calls"]
    assert all(st["samples"] + st["unread"] == st["replays"] and st["samples"] for st in snap["stages"].values())


@pytest.mark.cuda
def test_train_stage_marks_are_read_every_step(cuda_device, traced):
    """With the tracer on, the gradient and update graphs carry their stage
    marks; the loss fetch's synchronize lets every replay be read, and the
    steps match those of an untraced trainer from the same state (cuDNN's
    deterministic algorithms, as in the bit-for-bit test above)."""
    from slowfast_vos_tpu_torch.train.trainer import finite_loss

    pipes, calls = train_setup()
    start = {k: v.clone() for k, v in pipes[0].model.state_dict().items()}
    batch = calls[1][1]
    losses = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for on in (False, True):
            pipes[0].model.load_state_dict(start)
            if on:
                traced.enable()
            else:
                traced.disable()
            tr = Trainer(pipes[0], seed=3)
            losses.append([finite_loss(tr.step(batch)) for _ in range(4)])
    assert losses[0] == losses[1]
    snap = traced.take()
    stages = snap["stages"]
    grad = next(v for k, v in stages.items() if k.startswith("train.gradient"))
    assert (grad["replays"], grad["samples"]) == (3, 3) and stages["train.update"]["samples"] == 3
    assert sorted(grad["ms"]) == sorted(["transform", "backbone", "rpn", "slowfast", "roi_heads", "loss", "backward"])
    assert grad["ms"]["backward"] > 0 and list(stages["train.update"]["ms"]) == ["update"]
    assert snap["counters"]["train.steps"] == 4 and snap["totals"]["graphs.capture"]["calls"] == 2


@pytest.mark.cuda
def test_train_graphs_recapture_after_a_parameter_is_replaced(cuda_device):
    """A frozen parameter replaced after capture drops the step graphs; the
    next step captures anew, and the replays compute with the new tensor:
    a replayed step's losses equal an eager step's from the same state and
    caller draws."""
    pipes, calls = train_setup()
    tr = Trainer(pipes[0])
    runner, batch = tr.graphs, calls[1][1]
    draws = tr.make_draws(int(batch["boxes"].shape[1]))
    for _ in range(2):
        tr.step(batch, draws)
    assert runner.captures == 2
    conv = pipes[0].model.backbone.body.conv1
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 1.5, requires_grad=False)
    tr.step(batch, draws)
    assert runner.captures == 4
    start = {k: v.clone() for k, v in pipes[0].model.state_dict().items()}
    got = tr.step(batch, draws)
    assert runner.captures == 4
    pipes[0].model.load_state_dict(start)
    tr.graphs = None
    want = tr.step(batch, draws)
    assert all(torch.equal(got[k], want[k]) for k in want)


# K6, train-mode BatchNorm: (T, H, W) of the inputs, row counts (T*H*W)
# that no tile of `pbn.plan` divides at any C and dtype tested; the second
# spans the card's 132 SMs (the backward's slots overflow at C 192 and 224).
BN_SHAPES = ((3, 37, 29), (2, 131, 257))
BN_ROUTES = ("planned", "stream")  # the plan as it is; one slot a CTA, which streams any CTA of 2+ tiles


@pytest.fixture
def bn_route(request, monkeypatch):
    """`request.param` of BN_ROUTES: "stream" sets `pbn.MAX_SLOTS` to 1 for
    the test, so the elementwise pass reads all but a CTA's last tile again
    (the planned stream route keeps 6-13); the plans made meanwhile are
    dropped after it."""
    if request.param == "stream":
        monkeypatch.setattr(pbn, "MAX_SLOTS", 1)
        pbn.plan.cache_clear()
    yield request.param
    pbn.plan.cache_clear()


def bn_plan(x, dy_stride=None):
    return pbn.plan(x.numel() // x.shape[1], x.shape[1], x.dtype == torch.bfloat16, dy_stride,
                    torch.cuda.get_device_properties(x.device).multi_processor_count)


def bn_case(shape, c, dtype, seed, device="cuda"):
    """x [T, C, H, W] channels-last with per-channel means U(-1, 1) and
    spreads U(0.5, 2), channel 0 constant 0.1 (E[x^2] - E[x]^2 is rounding
    noise there, clamped where negative) and channel 1 constant 0.75
    (exactly 0); a BatchNorm3d with random affine and running statistics;
    and dy like x."""
    rng = np.random.default_rng(seed)
    t, h, w = shape
    mean, std = rng.uniform(-1, 1, c), rng.uniform(0.5, 2, c)
    x = mean[:, None, None] + std[:, None, None] * rng.standard_normal((t, c, h, w))
    x[:, 0], x[:, 1] = 0.1, 0.75
    bn = torch.nn.BatchNorm3d(c)
    with torch.no_grad():
        for p, lo, hi in ((bn.weight, 0.5, 1.5), (bn.bias, -0.5, 0.5), (bn.running_mean, -1, 1), (bn.running_var, 0.5, 2)):
            p.copy_(torch.from_numpy(rng.uniform(lo, hi, c)))
    as_x = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)  # noqa: E731
    return as_x(x), bn.to(device), as_x(rng.standard_normal((t, c, h, w)))


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each element's magnitude (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0**-126))) - 7)


def assert_bn_close(got, want, dtype, what):
    """f32: within 1e-5 of the tensor's max |want|. bf16: within one bf16
    ulp at the larger magnitude, plus 1e-6 of the max: the two sides'
    statistics differ in summation order by ~1e-7 relative, which moves an
    element's f32 value by ~1e-7 of the tensor's scale; that moves its
    rounding to bf16 by at most one ulp, or, where the value lies that
    close to 0 (the ReLU, a tiny magnitude), by that distance."""
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max())
    if dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= 1e-5 * scale, f"{what}: max abs err {err:.3e} against {scale:.3e}"
    else:
        excess = (got - want).abs() - bf16_ulp(torch.maximum(got.abs(), want.abs())) - 1e-6 * scale
        assert float(excess.max()) <= 0, f"{what}: {int((excess > 0).sum())} elements beyond one ulp"


def rel_to_max(got, want) -> float:
    return float((got - want).detach().abs().max() / want.detach().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bn_route", BN_ROUTES, indirect=True)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [32, 64, 192, 224])
def test_batch_norm_kernels_match_plain_versions(cuda_device, c, relu, dtype, bn_route):
    """K6 against its plain versions, each step on the same inputs: the
    statistics (mean, var) and the running statistics updated in place
    against `batch_norm_train_plain` on a copy of the module; y against
    `batch_norm_normalize` of the kernel's own statistics (a constant
    channel's invstd, 1/sqrt(eps), turns the plain f32 mean's rounding
    into ~1e-4 of y there, so the whole forward is not the yardstick of
    the normalize); dx, dweight and dbias against
    `batch_norm_train_backward_plain` on the kernel's statistics too, so
    both recompute the ReLU's mask alike, with k forced to 0 at channel 2
    (the clamp's branch, where the variance passes no gradient: random
    data reaches it only through rounding). Tolerances: `assert_bn_close` for
    y and dx; mean, var and the running statistics rel 1e-5 of each
    tensor's max; dweight and dbias rel 1e-4 (sums of N products in two
    orders). On the planned route and with the slots capped (every CTA of
    2+ tiles streams); the largest shape takes the stream route each way."""
    for i, shape in enumerate(BN_SHAPES):
        x, bn, dy = bn_case(shape, c, dtype, seed=10 * c + i)
        if bn_route == "stream" and i == 1:
            assert bn_plan(x).route == "stream" and bn_plan(x, c).route == "stream"
        plain = copy.deepcopy(bn)
        y, stats = pbn.batch_norm_forward_cuda(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, 0.9, relu)
        _, want_stats = batch_norm_train_plain(x, plain, 0.9, relu)
        want_y = batch_norm_normalize(x, stats, bn.weight, bn.bias, relu)
        assert y.is_contiguous(memory_format=torch.channels_last) and y.dtype == dtype
        assert_bn_close(y, want_y, dtype, f"y {shape}")
        for row, name in ((0, "mean"), (1, "var")):
            assert rel_to_max(stats[row], want_stats[row]) <= 1e-5, name
        for name in ("running_mean", "running_var"):
            assert rel_to_max(getattr(bn, name), getattr(plain, name)) <= 1e-5, name
        stats[3, 2] = 0.0
        dx, dw, db = pbn.batch_norm_backward_cuda(dy, x, stats, bn.weight, bn.bias, relu)
        want_dx, want_dw, want_db = batch_norm_train_backward_plain(dy, x, stats, bn.weight, bn.bias, relu)
        assert dx.is_contiguous(memory_format=torch.channels_last) and dx.dtype == dtype
        assert_bn_close(dx, want_dx, dtype, f"dx {shape}")
        assert rel_to_max(dw, want_dw) <= 1e-4 and rel_to_max(db, want_db) <= 1e-4


@pytest.mark.cuda
def test_batch_norm_kernel_statistics_under_cancellation(cuda_device):
    """Channels of mean 8 and spread 0.25 in f32, where E[x^2] - E[x]^2
    cancels three decimal digits: the kernel's mean and var against the
    same formula in float64 on the CPU, within 1e-6 of E[x^2] (16 f32 ulps
    of the terms whose difference var is); the plain version on the card
    is held to the same, as the yardstick of what f32 sums give."""
    rng = np.random.default_rng(40)
    x64 = 8 + 0.25 * rng.standard_normal((2, 64, 131, 257))
    x = torch.from_numpy(x64).float().to(cuda_device).contiguous(memory_format=torch.channels_last)
    xe = x.double().cpu()
    mean = xe.mean(dim=(0, 2, 3))
    var = ((xe * xe).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0)
    ex2 = (xe * xe).mean(dim=(0, 2, 3))
    bn = torch.nn.BatchNorm3d(64).to(cuda_device)
    _, stats = pbn.batch_norm_forward_cuda(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    _, plain = batch_norm_train_plain(x, torch.nn.BatchNorm3d(64).to(cuda_device))
    for name, s in (("kernel", stats), ("plain", plain)):
        s = s.double().cpu()
        assert float(((s[0] - mean).abs() / ex2).max()) <= 1e-6, name
        assert float(((s[1] - var).abs() / ex2).max()) <= 1e-6, name


@pytest.mark.cuda
@pytest.mark.parametrize("bn_route", BN_ROUTES, indirect=True)
def test_batch_norm_kernels_repeat_bitwise_and_under_a_graph(cuda_device, bn_route):
    """Forward and backward at the larger shape in bf16 with the ReLU: two
    calls from the same running statistics equal bit for bit, and a CUDA
    graph of both (a cooperative launch each, captured) replays them bit
    for bit, on the planned route (forward on chip, backward streaming) and
    with both streaming."""
    x, bn, dy = bn_case(BN_SHAPES[1], 192, torch.bfloat16, seed=41)
    start = [bn.running_mean.clone(), bn.running_var.clone()]

    def run():
        bn.running_mean.copy_(start[0])
        bn.running_var.copy_(start[1])
        y, stats = pbn.batch_norm_forward_cuda(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, 0.9, True)
        return [y, stats, bn.running_mean.clone(), bn.running_var.clone(),
                *pbn.batch_norm_backward_cuda(dy, x, stats, bn.weight, bn.bias, True)]

    want, again = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(want, again))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("bn_route", BN_ROUTES, indirect=True)
def test_batch_norm_kernels_take_channel_slices_and_partial_gradients(cuda_device, bn_route):
    """dy as a channel slice of a wider channels-last tensor (what the
    backward of SlowFast's channel `cat` gives; its tensor map carries the
    row stride) equals dy made contiguous,
    bit for bit; asking for dx alone, or for dweight and dbias alone, gives
    the same tensors as asking for all three."""
    x, bn, _ = bn_case(BN_SHAPES[1], 64, torch.bfloat16, seed=42)
    wide = torch.randn((x.shape[0], 256, *x.shape[2:]), device=cuda_device).to(torch.bfloat16)
    wide = wide.contiguous(memory_format=torch.channels_last)
    dy = wide[:, 192:]
    assert pbn.row_stride(dy) == 256 and not dy.is_contiguous(memory_format=torch.channels_last)
    _, stats = pbn.batch_norm_forward_cuda(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, 0.9, True)
    full = pbn.batch_norm_backward_cuda(dy, x, stats, bn.weight, bn.bias, True)
    dense = pbn.batch_norm_backward_cuda(dy.contiguous(memory_format=torch.channels_last), x, stats, bn.weight, bn.bias, True)
    assert all(torch.equal(a, b) for a, b in zip(full, dense))
    dx_only = pbn.batch_norm_backward_cuda(dy, x, stats, bn.weight, bn.bias, True, (True, False, False))
    params_only = pbn.batch_norm_backward_cuda(dy, x, stats, bn.weight, bn.bias, True, (False, True, True))
    assert torch.equal(dx_only[0], full[0]) and dx_only[1] is None and dx_only[2] is None
    assert params_only[0] is None and torch.equal(params_only[1], full[1]) and torch.equal(params_only[2], full[2])


@pytest.mark.cuda
def test_batch_norm_kernels_refuse_other_layouts(cuda_device):
    """An x that is not channels-last contiguous raises, and launches
    nothing; so does a dy whose rows are not 16-byte vectors of channels,
    also when autograd hands it to the fused function's backward, and a
    channel-slice dy whose rows are wider than a TMA box spans (f32, C 520:
    2080 bytes a row)."""
    x, bn, dy = bn_case(BN_SHAPES[0], 32, torch.float32, seed=43)
    before = dict(pbn.launches)
    with pytest.raises(ValueError, match="channels-last"):
        pbn.batch_norm_forward_cuda(x.contiguous(), bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    with pytest.raises(ValueError, match="channels-last"):
        pbn.batch_norm_train_fused(x.contiguous(), bn, relu=True)
    _, stats = batch_norm_train_plain(x, copy.deepcopy(bn))
    with pytest.raises(ValueError, match="channel slice"):
        pbn.batch_norm_backward_cuda(dy.contiguous(), x, stats, bn.weight, bn.bias)
    y = pbn.batch_norm_train_fused(x.requires_grad_(True), bn, relu=True)
    with pytest.raises(ValueError, match="channel slice"):
        y.backward(dy.contiguous())
    wide_x, wide_bn, _ = bn_case(BN_SHAPES[0], 520, torch.float32, seed=47)
    wider = torch.randn((x.shape[0], 528, *x.shape[2:]), device=cuda_device).contiguous(memory_format=torch.channels_last)
    _, wide_stats = batch_norm_train_plain(wide_x, copy.deepcopy(wide_bn))
    with pytest.raises(ValueError, match="channel slice"):
        pbn.batch_norm_backward_cuda(wider[:, 8:], wide_x, wide_stats, wide_bn.weight, wide_bn.bias, True)
    assert dict(pbn.launches) == {**before, "bn": before.get("bn", 0) + 1}


@pytest.mark.cuda
def test_batch_norm_path_has_no_host_synchronize(cuda_device):
    """`batch_norm_train_fused` forward and backward through autograd, the
    gradient a channel slice, under the sync debug mode "error"."""
    x, bn, other = bn_case(BN_SHAPES[1], 192, torch.bfloat16, seed=44)
    x.requires_grad_(True)

    def step():
        y = pbn.batch_norm_train_fused(x, bn, relu=True)
        torch.cat([y, other[:, :64]], dim=1).float().square().sum().backward()

    step()  # builds the library outside the checked region
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert x.grad is not None and bn.weight.grad is not None


@pytest.mark.cuda
def test_batch_norm_kernels_at_full_width_take_the_stream_route(cuda_device):
    """P2's `bn_s1` of a full-width step, [4, 192, 192, 336] bf16 with the
    ReLU (99 MB, more than the grid's shared memory holds): both plans
    stream, and the kernels agree with the plain versions as in
    `test_batch_norm_kernels_match_plain_versions`."""
    x, bn, dy = bn_case((4, 192, 336), 192, torch.bfloat16, seed=45)
    assert bn_plan(x).route == "stream" and bn_plan(x, 192).route == "stream"
    plain = copy.deepcopy(bn)
    y, stats = pbn.batch_norm_forward_cuda(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, 0.9, True)
    _, want_stats = batch_norm_train_plain(x, plain, 0.9, True)
    assert_bn_close(y, batch_norm_normalize(x, stats, bn.weight, bn.bias, True), torch.bfloat16, "y")
    for row, name in ((0, "mean"), (1, "var")):
        assert rel_to_max(stats[row], want_stats[row]) <= 1e-5, name
    dx, dw, db = pbn.batch_norm_backward_cuda(dy, x, stats, bn.weight, bn.bias, True)
    want_dx, want_dw, want_db = batch_norm_train_backward_plain(dy, x, stats, bn.weight, bn.bias, True)
    assert_bn_close(dx, want_dx, torch.bfloat16, "dx")
    assert rel_to_max(dw, want_dw) <= 1e-4 and rel_to_max(db, want_db) <= 1e-4


@pytest.mark.cuda
def test_batch_norm_kernels_on_two_streams_at_once(cuda_device):
    """Two streams queue K6 calls at once, forward and backward, each a
    cooperative grid of up to one CTA per SM (they cannot all be resident
    together: the card must hold one back, not hang), and each stream's
    results equal the same calls run alone, bit for bit."""
    cases = [bn_case(BN_SHAPES[1], c, torch.bfloat16, seed=46 + c) for c in (192, 64)]

    def run(x, bn, dy):
        y, stats = pbn.batch_norm_forward_cuda(x, bn.weight, bn.bias, bn.running_mean.clone(),
                                               bn.running_var.clone(), bn.eps, 0.9, True)
        return [y, stats, *pbn.batch_norm_backward_cuda(dy, x, stats, bn.weight, bn.bias, True)]

    want = [run(*case) for case in cases]
    streams = [torch.cuda.Stream() for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [None, None]
    for _ in range(20):
        for i, (s, case) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                got[i] = run(*case)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


@pytest.mark.cuda
def test_batch_norm_plan_asks_for_the_librarys_shared_memory(cuda_device):
    """`pbn.plan`'s shared memory per CTA, mirrored in Python, equals the
    library's own count (`sfvos_bn_smem_bytes`, the layout the kernels
    use) each way, in both dtypes, at every channel count of a training
    step and at C 1024, and stays under sm_90's cap."""
    lib = pbn._prepared(torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for c in (32, 64, 192, 224, 1024):
        for bf16 in (True, False):
            for dy_stride in (None, c):
                p = pbn.plan(258048, c, bf16, dy_stride, sms)
                assert p.smem == lib.sfvos_bn_smem_bytes(int(bf16), int(dy_stride is not None), c, p.tile_rows, p.slots)
                assert p.smem <= pbn.SMEM_MAX


def _k7_inputs(device, frames, windows, grid, seed=0, heads=12):
    """q, k, v as views of one [B, N, 3, heads, 64] qkv (strided, as the
    ViT hands them to K7), and the two position terms, bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, n = frames * windows, grid * grid
    qkv = torch.randn((b, n, 3, heads, 64), generator=g, device=device).bfloat16()
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    tables = [0.1 * torch.randn((2 * grid - 1, 64), generator=g, device=device) for _ in range(2)]
    rel_h, rel_w = patt.rel_pos_terms(q, *tables, (grid, grid))
    return q, k, v, rel_h, rel_w


@pytest.mark.cuda
@pytest.mark.parametrize("kind,windows,grid", [("global", 1, 64), ("window", 25, 14)])
def test_k7_matches_plain_version(cuda_device, kind, windows, grid):
    """K7 at ViTDet-B's shapes (2 frames: global N = 4096, 25 windows of
    N = 196 a frame), bf16, against the plain version in float32 on the same
    bf16 inputs: within 1e-2 + 2^-7 |o|. The kernel rounds the
    probabilities to bf16 before the second product (2^-9 each, over a
    weighted mean of unit values) and its output once; the rest is f32."""
    q, k, v, rel_h, rel_w = _k7_inputs(cuda_device, 2, windows, grid)
    before = patt.launches["attention", kind]
    got = patt.attention(q, k, v, rel_h, rel_w, 0.125, kind)
    assert patt.launches["attention", kind] == before + 1
    assert got.shape == (q.shape[0], q.shape[2], 12, 64) and got.dtype == torch.bfloat16
    want = patt.attention_plain(*(t.float() for t in (q, k, v, rel_h, rel_w)), 0.125)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=2.0**-7)
    # Dropping a term moves the output far past that tolerance.
    off = patt.attention_plain(*(t.float() for t in (q, k, v, rel_h, torch.zeros_like(rel_w))), 0.125)
    assert (off - want).abs().max() > 0.1


@pytest.mark.cuda
def test_k7_allocates_no_square_of_the_tokens(cuda_device):
    """A global call at N = 4096 allocates its output and nothing of N^2
    elements (one head's logits in bf16 would be 33.5 MB)."""
    q, k, v, rel_h, rel_w = _k7_inputs(cuda_device, 1, 1, 64)
    patt.attention(q, k, v, rel_h, rel_w, 0.125, "global")  # built and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    out = patt.attention(q, k, v, rel_h, rel_w, 0.125, "global")
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda_device) - base
    assert grown <= out.numel() * out.element_size() + (1 << 20) < 4096 * 4096 * 2


@pytest.mark.cuda
def test_vitdet_pipeline_graphs_match_eager_and_launch_k7(cuda_device):
    """ViTDet-B + SlowFast 3-3 at its published widths on a 1024 canvas: a
    40-frame sequence (first and carried superchunks) on the graph path
    against the eager path, bit for bit; each superchunk's replay launches
    K7 4 times global and 8 times windowed, K1 twice and K3 twice."""
    torch.manual_seed(0)
    pipe, model = build_pipeline(3, 3, (480, 854), arch="vitdet-b", min_size=1024, max_size=1024,
                                 device=cuda_device, superchunk=32)
    init_weights(model, 0)
    clip = (np.random.default_rng(3).random((40, 480, 854, 3)) * 255).astype(np.uint8)
    got = pipe.infer_sequence(clip)
    assert pipe.graphs.captures == 2
    for captured in pipe.graphs.graphs.values():
        assert captured.launches[("attention", "global")] == 4 and captured.launches[("attention", "window")] == 8
        assert captured.launches[7] == 1 and captured.launches[14] == 1 and captured.launches["nms"] == 2
    want = Pipeline(model, pipe.transform, superchunk=32, graphs=False).infer_sequence(clip)
    for g, w in zip(got, want):
        for key in ("boxes", "scores", "labels", "valid", "union_mask"):
            np.testing.assert_array_equal(g[key], w[key])


K8_MODES = {"bias": (False, False), "bias_relu": (False, True), "bias_residual_relu": (True, True)}


def _k8_inputs(device, c, dtype, residual, seed=0, shape=(3, 13, 17)):
    """x (and a residual) [N, C, H, W] channels-last at a ragged H x W, and
    a float32 bias, seeded."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, h, w = shape
    as_cl = lambda t: t.to(dtype).contiguous(memory_format=torch.channels_last)  # noqa: E731
    x = as_cl(torch.randn((n, c, h, w), generator=g, device=device))
    res = as_cl(torch.randn((n, c, h, w), generator=g, device=device)) if residual else None
    return x, torch.randn((c,), generator=g, device=device), res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [40, 64, 120, 256, 512, 2048])
@pytest.mark.parametrize("mode", list(K8_MODES))
def test_k8_matches_plain_version(cuda_device, mode, c, dtype):
    """K8 against its plain version on the same inputs: within one bf16 ulp
    (both add in float32 in one order and round once), float32 within
    1e-6; one launch a call under "epilogue"; without autograd recording
    the main path's call writes over x. Each tensor spans about three
    strides of K8's persistent grid (8 CTAs of 4 x 256 vectors an SM), so a
    thread carries its channel group from one stride to the next; at C 40
    and 120 (not a power of two) that group moves by a non-zero step."""
    residual, relu = K8_MODES[mode]
    width = 16 // dtype.itemsize  # channels a vector
    stride = torch.cuda.get_device_properties(cuda_device).multi_processor_count * 8 * 4 * 256 * width
    h, w = 97, 131
    n = -(-3 * stride // (c * h * w))
    if c in (40, 120):
        assert stride // width % (c // width) != 0
    x, bias, res = _k8_inputs(cuda_device, c, dtype, residual, shape=(n, h, w))
    want = pce.conv_epilogue_plain(x, bias, res, relu)
    before = pce.launches["epilogue"]
    got = pce.conv_epilogue_cuda(x, bias, res, relu)
    assert pce.launches["epilogue"] == before + 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.bfloat16:
        excess = (got.float() - want.float()).abs() - bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
        assert float(excess.max()) <= 0
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        inplace = pce.conv_epilogue(x, bias, res, relu)
    assert inplace.data_ptr() == x.data_ptr() and torch.equal(inplace, got)


@pytest.mark.cuda
def test_k8_refuses_other_layouts_dtypes_and_widths(cuda_device):
    """NCHW-contiguous, float16 and C % 8 != 0 raise before a launch;
    nothing is copied to make them fit."""
    x, bias, _ = _k8_inputs(cuda_device, 64, torch.bfloat16, False)
    before = pce.launches["epilogue"]
    for bad_x, bad_bias in ((x.contiguous(), bias), (x.half(), bias),
                            (x[:, :60].contiguous(memory_format=torch.channels_last), bias[:60])):
        with pytest.raises(ValueError):
            pce.conv_epilogue(bad_x, bad_bias, None, True)
    assert pce.launches["epilogue"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", list(K8_MODES))
def test_k8_autograd_matches_autograd_through_the_plain_version(cuda_device, mode, dtype):
    """Where autograd records, K8 runs in its Function: the output as the
    kernel's, and the gradients of x, the bias and the residual as autograd
    gives them through the plain version, within one rounding of the
    gradient's dtype (the bias's summed in float32)."""
    residual, relu = K8_MODES[mode]
    x, bias, res = _k8_inputs(cuda_device, 256, dtype, residual, seed=1)
    leaves = [t.detach().requires_grad_() for t in (x, bias, res) if t is not None]
    g = torch.randn(x.shape, device=cuda_device).to(dtype).contiguous(memory_format=torch.channels_last)
    before = pce.launches["epilogue"]
    got = pce.conv_epilogue(leaves[0], leaves[1], leaves[2] if residual else None, relu)
    assert pce.launches["epilogue"] == before + 1 and got.grad_fn is not None
    got_grads = torch.autograd.grad(got, leaves, g)
    want = pce.conv_epilogue_plain(leaves[0], leaves[1], leaves[2] if residual else None, relu)
    want_grads = torch.autograd.grad(want, leaves, g)
    assert torch.equal(got.detach(), want.detach())
    for got_g, want_g in zip(got_grads, want_grads):
        assert got_g.dtype == want_g.dtype
        torch.testing.assert_close(got_g, want_g, rtol=2.0**-7 if dtype == torch.bfloat16 else 1e-5, atol=1e-3)


@pytest.mark.cuda
def test_backbone_on_k8_matches_the_cpu(cuda_device):
    """The folded ResNet-50 + FPN in float32 (TF32 off) on the card, through
    K8 (K8_PER_BACKBONE launches), against the same model's plain path on
    the CPU."""
    from test_torch_conv_epilogue import images, seeded_backbone

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = seeded_backbone()
    x = images()
    with torch.no_grad():
        want = model(x)
        model.to(cuda_device)
        before = pce.launches["epilogue"]
        got = model(x.to(cuda_device))
    assert pce.launches["epilogue"] == before + K8_PER_BACKBONE
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
