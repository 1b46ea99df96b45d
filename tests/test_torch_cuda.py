"""The PyTorch port's checks that need the card: the RoIAlign kernel and
its backward against their plain versions, the level assignment on the
card against the CPU's, the YUV 4:2:0 decode on the card against the CPU's,
the blocked NMS sweep on the card against the fixpoint, the NMS kernel
(K3) against the fixpoint, index for index, the superchunk's CUDA
graphs (`models/graphs.py`) against the eager path, bit for bit, and the
training step's (`train/graphs.py`) likewise.
Imports neither JAX's models nor flax, so it runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q

Every test is marked `cuda` and skips where CUDA is absent."""
import numpy as np
import pytest
import torch

from torch_roi_cases import boundary_rois, clustered_batch, cuda_device, edge_case_batch  # noqa: F401 (fixture)
from slowfast_vos_tpu_torch.models.pipeline import Pipeline, build_pipeline, frame_detections, init_weights
from slowfast_vos_tpu_torch.models.transform import ImageTransform
from slowfast_vos_tpu_torch.ops import nms as pnms
from slowfast_vos_tpu_torch.ops import roi_align as pra
from slowfast_vos_tpu_torch import data
from slowfast_vos_tpu_torch.train import Trainer
from slowfast_vos_tpu_torch.train.pretrain import warmup_step_lr


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
def test_from_yuv420_on_the_card_matches_cpu(cuda_device):
    """The same uint8 planes decoded on the card and on the CPU, f32 (the
    resize tolerance of tests/test_torch_models.py, atol 1e-4)."""
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.integers(0, 256, (3, 120, 200), dtype=np.uint8))
    uv = torch.from_numpy(rng.integers(0, 256, (3, 60, 100, 2), dtype=np.uint8))
    tf = ImageTransform((120, 200), min_size=128, max_size=256)
    got = tf.from_yuv420(y.to(cuda_device), uv.to(cuda_device))
    torch.testing.assert_close(got.cpu(), tf.from_yuv420(y, uv), atol=1e-4, rtol=0)


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
@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
@pytest.mark.parametrize("size", ["small", "full"])
def test_graph_path_equals_eager_bit_for_bit(cuda_device, size, transport, instance_masks):
    """`infer_sequence` through the graphs (the first run: each key's first
    chunk eager, then replays; the second run: replays only) against the
    eager path on the same model: every output equal bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe, eager, clip = graph_and_eager(size)
    want = eager.infer_sequence(clip, instance_masks=instance_masks, transport=transport)
    assert any(d["valid"].any() for d in want)
    for _ in range(2):
        assert_same_detections(pipe.infer_sequence(clip, instance_masks=instance_masks, transport=transport), want)
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
@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
def test_graph_path_has_no_host_synchronize(cuda_device, transport):
    """After a first run has captured the graphs, the host's part of a run
    (staging, uploads, copies into the static inputs, replays, clones)
    under the sync debug mode "error"; only the final fetch waits."""
    pipe, eager, clip = graph_and_eager("small")
    want = eager.infer_sequence(clip, transport=transport)
    pipe.infer_sequence(clip, transport=transport)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pipe.infer_chunks(clip, transport=transport)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_same_detections(frame_detections(pending, clip.shape[0], clip.shape[2]), want)


@pytest.mark.cuda
def test_graph_replays_count_their_kernel_launches(cuda_device):
    """A replay adds the K1 (7, 14) and K3 launches its graph recorded at
    capture: a warm run counts what the eager path counts, one launch of
    each pool and two of K3 per superchunk; capture itself counts none."""
    pipe, eager, clip = graph_and_eager("small")
    chunks = -(-clip.shape[0] // pipe.superchunk)
    counts = []
    for p in (eager, pipe, pipe):
        before = {k: pra.launches[k] for k in (7, 14, "nms")}
        p.infer_sequence(clip)
        counts.append({k: pra.launches[k] - v for k, v in before.items()})
    assert counts == [{7: chunks, 14: chunks, "nms": 2 * chunks}] * 3
    for captured in pipe.graphs.graphs.values():
        assert captured.launches == {7: 1, 14: 1, "nms": 2}


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
    """Each gradient graph records one launch of K1 and K5 at both pools and
    one of K3 (the backward's from autograd's thread too), the update graph
    none; a replayed step counts what an eager step counts."""
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
    assert [c.launches for c in runner.graphs.values()] == [{k: 1 for k in TRAIN_KEYS}]
    assert runner.update.launches == {}


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
