"""Parity of the PyTorch port's ops (`slowfast_vos_tpu_torch/ops/`) with the
JAX package on the same seeded inputs: boxes, anchors, NMS and top-k
(index-exact, on tie-heavy inputs; the fixpoint and the blocked sweep), the
multi-scale RoIAlign's plain version (against the JAX gather and the Pallas
kernel in interpret mode), the single-map RoIAlign and the mask paste, and the pool's plain backward (against `jax.vjp` of the JAX
package's custom-VJP pool and against autograd through the plain forward).
The CUDA kernels' own checks, which need the card, are in
`test_torch_cuda.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import t
from torch_roi_cases import boundary_rois, edge_case_batch
from slowfast_vos_tpu.models.anchors import fpn_anchors as jax_fpn_anchors
from slowfast_vos_tpu.ops import boxes as jboxes
from slowfast_vos_tpu.ops import nms as jnms
from slowfast_vos_tpu.ops.paste_masks import paste_masks_in_image as jax_paste
from slowfast_vos_tpu.ops.roi_align import fpn_level_assignment as jax_levels
from slowfast_vos_tpu.ops.roi_align import multiscale_roi_align as jax_roi_align
from slowfast_vos_tpu.ops.roi_align import roi_align as jax_single_roi_align
from slowfast_vos_tpu.ops.roi_align_mm import _interp_matrix_1d as jax_interp_matrix_1d
from slowfast_vos_tpu.ops.roi_align_mm import multiscale_roi_align_mmgrad
from slowfast_vos_tpu.ops.roi_align_pallas import multiscale_roi_align_pallas
from slowfast_vos_tpu_torch.models.anchors import fpn_anchors
from slowfast_vos_tpu_torch.ops import boxes as pboxes
from slowfast_vos_tpu_torch.ops import nms as pnms
from slowfast_vos_tpu_torch.ops import roi_align as pra
from slowfast_vos_tpu_torch.ops.paste_masks import paste_masks_in_image

SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


def random_boxes(rng, n, extent=100.0, quantum=None):
    xy = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(1, extent / 2, (n, 2))
    b = np.concatenate([xy, xy + wh], 1)
    if quantum:  # coarse grid -> duplicate boxes and exact IoU ties
        b = np.round(b / quantum) * quantum
    return b.astype(np.float32)


def test_anchors_equal_jax():
    hws = [(32, 48), (16, 24), (8, 12), (4, 6), (2, 3)]
    for a, b in zip(fpn_anchors(hws), jax_fpn_anchors(hws)):
        np.testing.assert_array_equal(a, b)


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 40), random_boxes(rng, 30)
    # f32 elementwise ops in the same order: exact up to 1 ulp.
    np.testing.assert_allclose(pboxes.box_iou(t(a), t(b)).numpy(), np.asarray(jboxes.box_iou(a, b)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pboxes.clip_boxes(t(a), (60.0, 80.0)).numpy(), np.asarray(jboxes.clip_boxes(a, (60.0, 80.0))))
    np.testing.assert_array_equal(
        pboxes.remove_small_boxes_mask(t(a), 20.0).numpy(), np.asarray(jboxes.remove_small_boxes_mask(a, 20.0))
    )
    w = (10.0, 10.0, 5.0, 5.0)
    enc = pboxes.encode_boxes(t(a[:30]), t(b), w)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jboxes.encode_boxes(a[:30], b, w)), rtol=1e-5, atol=1e-5)
    deltas = rng.normal(size=(40, 4)).astype(np.float32) * 3  # some dw/dh hit the clamp
    np.testing.assert_allclose(
        pboxes.decode_boxes(t(deltas), t(a), w).numpy(), np.asarray(jboxes.decode_boxes(deltas, a, w)), rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_nms_mask_index_exact(thr):
    """Quantized boxes and scores: duplicates, equal scores and IoU ties.
    Keep mask and order must equal the JAX fixpoint's, index for index."""
    rng = np.random.default_rng(1)
    boxes = random_boxes(rng, 300, quantum=8.0)
    scores = (np.round(rng.uniform(0, 1, 300) * 8) / 8).astype(np.float32)
    valid = rng.uniform(size=300) > 0.1
    keep, order = pnms.nms_mask(t(boxes), t(scores), t(valid), iou_threshold=thr)
    jkeep, jorder = jnms.nms_mask(boxes, scores, valid, iou_threshold=thr, algorithm="fixpoint")
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < keep.sum() < valid.sum()


def test_nms_batched_over_leading_dims_equals_per_problem():
    rng = np.random.default_rng(2)
    boxes = np.stack([random_boxes(rng, 120, quantum=4.0) for _ in range(6)]).reshape(2, 3, 120, 4)
    scores = (np.round(rng.uniform(0, 1, (2, 3, 120)) * 16) / 16).astype(np.float32)
    keep, order = pnms.nms_mask(t(boxes), t(scores), iou_threshold=0.7)
    for i in range(2):
        for j in range(3):
            jk, jo = jnms.nms_mask(boxes[i, j], scores[i, j], iou_threshold=0.7)
            np.testing.assert_array_equal(keep[i, j].numpy(), np.asarray(jk))
            np.testing.assert_array_equal(order[i, j].numpy(), np.asarray(jo))


def test_batched_nms_and_top_k_index_exact():
    """Class-keyed NMS (offset over ALL boxes, invalid ones included) and the
    static top-k with ties and fewer candidates than k."""
    rng = np.random.default_rng(3)
    boxes = random_boxes(rng, 200, quantum=6.0)
    boxes[5] = [900.0, 900.0, 950.0, 950.0]  # invalid but sets the offset
    scores = (np.round(rng.uniform(0, 1, 200) * 10) / 10).astype(np.float32)
    labels = rng.integers(1, 4, 200).astype(np.int32)
    valid = rng.uniform(size=200) > 0.2
    valid[5] = False
    keep, _ = pnms.batched_nms_mask(t(boxes), t(scores), t(labels), t(valid), iou_threshold=0.5)
    jkeep, jorder = jnms.batched_nms_mask(boxes, scores, labels, valid, iou_threshold=0.5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    for k in (10, 150, 250):
        idx, ok = pnms.top_k_after_nms(keep, t(scores), k)
        jidx, jok = jnms.top_k_after_nms(jkeep, jorder, scores, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def _tie_heavy(rng, n, quantum=8.0):
    boxes = random_boxes(rng, n, quantum=quantum)
    scores = (np.round(rng.uniform(0, 1, n) * 8) / 8).astype(np.float32)
    return boxes, scores, rng.uniform(size=n) > 0.1


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_blocked_nms_index_exact(thr):
    """The blocked sweep at N = 300, B = 128 (a ragged last block padded with
    invalid boxes) on quantized boxes and scores (duplicates, equal scores
    across block boundaries, IoU ties): keep and order equal JAX's
    `algorithm="blocked"` and the port's fixpoint, index for index."""
    boxes, scores, valid = _tie_heavy(np.random.default_rng(11), 300)
    keep, order = pnms.nms_mask(t(boxes), t(scores), t(valid), iou_threshold=thr, algorithm="blocked")
    jkeep, jorder = jnms.nms_mask(boxes, scores, valid, iou_threshold=thr, block_size=128, algorithm="blocked")
    fkeep, forder = pnms.nms_mask(t(boxes), t(scores), t(valid), iou_threshold=thr, algorithm="fixpoint")
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert torch.equal(order, forder) and torch.equal(keep, fkeep)
    assert 0 < keep.sum() < valid.sum()


def test_blocked_nms_batched_over_leading_dims_equals_per_problem():
    """Leading batch dims through the blocked sweep (B = 64, N = 150: two
    full blocks and a ragged one) against JAX's blocked NMS per problem."""
    rng = np.random.default_rng(12)
    boxes = np.stack([random_boxes(rng, 150, quantum=4.0) for _ in range(6)]).reshape(2, 3, 150, 4)
    scores = (np.round(rng.uniform(0, 1, (2, 3, 150)) * 16) / 16).astype(np.float32)
    valid = rng.uniform(size=(2, 3, 150)) > 0.1
    keep, order = pnms.nms_mask(t(boxes), t(scores), t(valid), iou_threshold=0.7, block_size=64, algorithm="blocked")
    for i in range(2):
        for j in range(3):
            jk, jo = jnms.nms_mask(boxes[i, j], scores[i, j], valid[i, j], iou_threshold=0.7, block_size=64, algorithm="blocked")
            np.testing.assert_array_equal(keep[i, j].numpy(), np.asarray(jk))
            np.testing.assert_array_equal(order[i, j].numpy(), np.asarray(jo))


def test_nms_auto_takes_the_blocked_sweep_above_the_fixpoint_limit(monkeypatch):
    """"auto" (the default of `nms_mask` and `batched_nms_mask`) runs the
    fixpoint up to `FIXPOINT_MAX_N` boxes and the blocked sweep above, with
    the same answer as JAX's "auto", which at this N is its fixpoint."""
    calls = []
    blocked = pnms._nms_blocked
    monkeypatch.setattr(pnms, "_nms_blocked", lambda *a: calls.append(a[-1]) or blocked(*a))
    rng = np.random.default_rng(13)
    boxes, scores, valid = _tie_heavy(rng, 200, quantum=6.0)
    labels = rng.integers(1, 4, 200).astype(np.int32)
    jkeep, _ = jnms.batched_nms_mask(boxes, scores, labels, valid, iou_threshold=0.5)
    keep, _ = pnms.batched_nms_mask(t(boxes), t(scores), t(labels), t(valid), iou_threshold=0.5)
    assert calls == []
    monkeypatch.setattr(pnms, "FIXPOINT_MAX_N", 199)
    bkeep, _ = pnms.batched_nms_mask(t(boxes), t(scores), t(labels), t(valid), iou_threshold=0.5, block_size=32)
    assert calls == [32]
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert torch.equal(bkeep, keep)


def test_nms_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """K3's input checks run before any build or launch, so they are
    testable without the card; so is the chunking of problems, a function
    of the shapes."""
    boxes, eff = torch.zeros(2, 5, 64, 4), torch.zeros(2, 5, 64)
    order = torch.arange(64).expand(2, 5, 64).contiguous()
    pnms._check_nms_inputs(boxes, eff, order)
    pnms._check_nms_inputs(boxes[:, :, :0], eff[:, :, :0], order[:, :, :0])
    pnms._check_nms_inputs(boxes, eff.bfloat16(), order)
    pnms._check_nms_inputs(boxes, eff.half(), order)
    with pytest.raises(TypeError, match="float32 boxes"):
        pnms._check_nms_inputs(boxes.double(), eff, order)
    with pytest.raises(TypeError, match="float32 boxes"):
        pnms._check_nms_inputs(boxes.bfloat16(), eff, order)
    with pytest.raises(TypeError, match="float16 or bfloat16 scores"):
        pnms._check_nms_inputs(boxes, eff.double(), order)
    with pytest.raises(TypeError, match="int64 order"):
        pnms._check_nms_inputs(boxes, eff, order.int())
    for b, e, o in ((boxes[..., :3], eff, order), (boxes, eff[..., :63], order), (boxes, eff, order[..., :63]),
                    (boxes[0, 0, 0], eff[0, 0, 0], order[0, 0, 0]), (boxes, eff[0], order[0])):
        with pytest.raises(ValueError, match=r"\[\.\.\., N, 4\]"):
            pnms._check_nms_inputs(b, e, o)
    with pytest.raises(ValueError, match="contiguous"):
        pnms._check_nms_inputs(boxes.transpose(0, 1), eff.transpose(0, 1), order.transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        pnms._check_nms_inputs(boxes, eff.transpose(0, 1).contiguous().transpose(0, 1), order)
    with pytest.raises(ValueError, match="share one device"):
        pnms._check_nms_inputs(boxes, eff.to("meta"), order)
    with pytest.raises(ValueError, match="share one device"):
        pnms._check_nms_inputs(boxes, eff, order.to("meta"))
    shifted = torch.empty(boxes.numel() + 1)[1:].view(boxes.shape)  # contiguous, 4 bytes into its storage
    with pytest.raises(ValueError, match="16-byte aligned"):
        pnms._check_nms_inputs(shifted, eff, order)
    n = pnms.KERNEL_MAX_N + 1
    with pytest.raises(ValueError, match=f"at most {pnms.KERNEL_MAX_N}"):
        pnms._check_nms_inputs(torch.zeros(1, n, 4), torch.zeros(1, n), torch.zeros(1, n, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pnms.nms_cuda(boxes, eff, order, 0.5)
    with pytest.raises(ValueError, match="no NMS for device meta"):
        pnms.nms_mask(boxes.to("meta"), torch.zeros(2, 5, 64, device="meta"), torch.ones(2, 5, 64, dtype=torch.bool, device="meta"))
    # The shared route takes no scratch and every problem in one launch;
    # the global route's bitmask is 8.4 MB a problem at 8192 boxes (32 to
    # the budget), 0.54 GB at 65536 (one a launch, over the budget).
    assert pnms.problems_per_launch(40, 1000) == 40
    assert pnms.problems_per_launch(10, 2000) == 10
    assert pnms.problems_per_launch(3, 60_000) == 1
    assert pnms.problems_per_launch(10**9, 64) == pnms.KERNEL_MAX_PROBLEMS
    assert pnms.problems_per_launch(100, 8192) == pnms.SCRATCH_BUDGET // (8192 * 128 * 8) == 32
    assert pnms.scratch_bytes(40, 1000) == 0 and pnms.scratch_bytes(1, 60_000) == 16 * 59 * 64 * 938 * 8


@pytest.mark.parametrize("thr", [0.0, 0.5, 0.7])
def test_kernel_pair_test_with_early_out_equals_box_iou(thr):
    """K3's pair test (`pair_overlaps_plain`: no division where the boxes
    do not overlap on both axes, tested as the kernel tests it) against
    `box_iou(a, b) > thr`, bit for bit, on f32 edge cases: zero
    width and height, touching edges and corners, identical and nested
    boxes, inverted boxes, subnormal overlaps, NaN and +-inf coordinates,
    IoU exactly at the threshold, and quantized random boxes."""
    inf, nan, tiny = float("inf"), float("nan"), 1e-45
    edge = [
        [0, 0, 10, 10], [0, 0, 10, 10], [10, 0, 20, 10], [0, 10, 10, 20], [10, 10, 20, 20],  # identical, touching
        [5, 5, 5, 15], [5, 5, 15, 5], [5, 5, 5, 5],  # zero width, zero height, a point
        [0, 0, 20, 10], [0, 0, 20, 20], [2, 2, 8, 8], [10, 10, 0, 0], [8, 8, 2, 2],  # IoU 0.5, nested, inverted
        [0, 0, tiny, 10], [-tiny, 0, 0, 10], [9.999999, 0, 20, 10],  # subnormal and one-ulp overlaps
        [nan, 0, 10, 10], [0, nan, 10, 10], [0, 0, nan, 10], [nan, nan, nan, nan],
        [-inf, -inf, inf, inf], [0, 0, inf, 10], [-inf, 0, 10, 10], [inf, inf, inf, inf], [-inf, 0, -inf, 10],
        [0, -inf, 10, inf], [5, 5, inf, inf],
    ]
    rng = np.random.default_rng(40)
    rand = random_boxes(rng, 40, extent=30.0, quantum=2.0)
    boxes = torch.cat([torch.tensor(edge, dtype=torch.float32), torch.from_numpy(rand)])
    got = pnms.pair_overlaps_plain(boxes, boxes, thr)
    want = pboxes.box_iou(boxes, boxes) > thr
    assert torch.equal(got, want)
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    skipped = ~(rb > lt).all(-1)
    assert skipped.sum() > boxes.shape[0] and (~skipped).sum() > boxes.shape[0]  # both branches taken


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_kernel_candidate_flag_equals_score_order(dtype):
    """The kernel tests `eff > flag_min` on the scores cast to float32, with
    `_FLAG_MIN[dtype]`; `score_order` tests `eff > NEG_INF / 2` in the
    scores' own dtype. Equal on every value near the threshold, on -1e10,
    +-inf and NaN, valid or not (float16: no flags)."""
    base = torch.tensor([pnms.NEG_INF / 2], dtype=dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    near = (base.view(bits) + torch.tensor([-1, 0, 1], dtype=bits)).view(dtype)  # the threshold and its neighbours
    special = torch.tensor([pnms.NEG_INF, -float("inf"), float("inf"), float("nan"), 0.0, -4e9, -6e9]).to(dtype)
    scores = torch.cat([near, special, base])
    # NEG_INF overflows float16, which `full_like` refuses: float16 scores come without flags.
    valid = None if dtype == torch.float16 else torch.arange(scores.numel()) % 3 != 1
    eff, order = pnms.effective_order(scores, valid)
    _, _, svalid = pnms.score_order(torch.zeros(scores.numel(), 4), scores, valid)
    kernel_flag = eff.float() > pnms._FLAG_MIN[dtype]
    assert torch.equal(kernel_flag[order], svalid)
    assert svalid.any() and not svalid.all()


def test_nms_kernel_route_cluster_and_scratch_by_n():
    """K3's shape functions: the cluster size (about two 64-box blocks a
    CTA, 1 to 16), the route (the bitmask in shared memory up to
    SHARED_ROUTE_MAX_N = 5120 boxes, then in device memory), the shared
    memory a CTA takes (below the budget on the shared route), the
    scratch and the problems per launch; all from the shapes alone."""
    sizes = {1: 1, 63: 1, 64: 1, 65: 1, 127: 1, 128: 1, 129: 2, 256: 2, 257: 4, 512: 4, 513: 8, 1000: 8, 1024: 8,
             1025: 16, 2000: 16, 8192: 16, pnms.KERNEL_MAX_N: 16}
    assert {n: pnms.cluster_size(n) for n in sizes} == sizes
    assert pnms.SHARED_ROUTE_MAX_N == 5120
    for n in (1, 64, 65, 1000, 2000, 4096, 5120):
        assert pnms.route(n) == "shared" and pnms.scratch_bytes(7, n) == 0
        assert pnms.shared_bytes(n, pnms.cluster_size(n), "shared") <= pnms.SHARED_BUDGET
    for n in (5121, 8192, pnms.KERNEL_MAX_N):
        assert pnms.route(n) == "global"
        assert pnms.shared_bytes(n, 16, "global") <= pnms.SHARED_BUDGET < pnms.shared_bytes(n, 16, "shared")
    # 8192 boxes: 128 blocks, 8 a CTA of 16; the layout of csrc/nms.cu.
    assert pnms.shared_bytes(8192, 16, "global") == 24 * 64 * 8 + 3 * 8 * 8 + 3 * 8 * 128
    assert pnms.shared_bytes(8192, 16, "shared") == pnms.shared_bytes(8192, 16, "global") + 8 * 8 * 64 * 128
    assert pnms.scratch_bytes(3, 8192) == 3 * 8192 * 128 * 8
    assert pnms.scratch_bytes(1, 5121) == 16 * 6 * 64 * 81 * 8  # C does not divide W = 81: 96 blocks of rows
    assert pnms.problems_per_launch(40, 5120) == 40 and pnms.problems_per_launch(40, 5121) == 40
    assert pnms.problems_per_launch(1000, 5121) == pnms.SCRATCH_BUDGET // pnms.scratch_bytes(1, 5121)
    assert pnms.problems_per_launch(0, 1000) == 0


def test_nms_rejects_an_unknown_algorithm():
    with pytest.raises(ValueError, match="algorithm"):
        pnms.nms_mask(torch.zeros(3, 4), torch.zeros(3), algorithm="greedy")


@pytest.mark.parametrize("out_size,scale", [(7, 1 / 4), (14, 1 / 8)])
def test_single_map_roi_align_matches_jax(out_size, scale):
    """`ops.roi_align.roi_align` on one [H, W, C] map against JAX's
    `roi_align` (the same gather; f32 sum order only: atol 1e-5)."""
    rng = np.random.default_rng(14)
    feat = rng.normal(size=(int(192 * scale), int(336 * scale), 8)).astype(np.float32)
    rois = _rois(rng, 24)
    got = pra.roi_align(t(feat), t(rois), scale, output_size=out_size)
    want = np.asarray(jax_single_roi_align(jnp.asarray(feat), jnp.asarray(rois), scale, output_size=out_size))
    assert got.shape == want.shape == (len(rois), out_size, out_size, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_paste_masks_matches_jax():
    rng = np.random.default_rng(4)
    masks = rng.uniform(size=(7, 28, 28)).astype(np.float32)
    boxes = random_boxes(rng, 7, extent=90.0)
    boxes[0] = [-5.3, -2.2, 40.7, 70.1]  # partly outside the image
    boxes[1] = [10.0, 10.0, 10.4, 10.2]  # sub-pixel
    valid = np.array([True, True, True, False, True, True, True])
    got = paste_masks_in_image(t(masks), t(boxes), (60, 100), t(valid)).numpy()
    want = np.asarray(jax_paste(masks, boxes, (60, 100), valid))
    np.testing.assert_allclose(got, want, atol=1e-5)  # f32 matmul order


def _pyramid(rng, frames, c=8):
    """DAVIS-like pyramid geometry at 1/4 linear scale
    (tests/test_roi_align_pallas.py)."""
    return [rng.normal(size=(frames, 192 // s, 336 // s, c)).astype(np.float32) for s in (4, 8, 16, 32)]


def _rois(rng, n):
    xy = rng.uniform(-10, 300, (n, 2))
    wh = rng.uniform(4, 120, (n, 2))
    extra = np.array(
        [
            [0.0, 0.0, 1.5, 1.5],  # sub-pixel box
            [330.0, 188.0, 345.0, 200.0],  # past the bottom-right edge
            [50.0, 50.0, 50.0, 50.0],  # degenerate (zero area)
            [10.0, 80.0, 190.0, 125.0],  # 4:1 aspect, inside the Pallas patch
            [-20.0, -20.0, 4.0, 4.0],  # mostly off-canvas
        ],
        np.float32,
    )
    return np.concatenate([np.concatenate([xy, xy + wh], 1).astype(np.float32), extra])


def test_level_assignment_matches_jax():
    rng = np.random.default_rng(5)
    rois = _rois(rng, 200) * 4
    np.testing.assert_array_equal(pra.fpn_level_assignment(t(rois)).numpy(), np.asarray(jax_levels(rois)))


def test_level_assignment_at_level_boundaries_matches_jax():
    rois = boundary_rois()
    np.testing.assert_array_equal(pra.fpn_level_assignment(rois).numpy(), np.asarray(jax_levels(rois.numpy())))


@pytest.mark.parametrize("out_size", [7, 14])
def test_plain_roi_align_matches_jax_gather_and_pallas(out_size):
    """The plain version against the JAX gather form (exact semantics, f32
    sum order only: atol 1e-5) and against the Pallas kernel in interpret
    mode on rois inside its patch (its own test's tolerance, 2e-4)."""
    rng = np.random.default_rng(0)
    feats = _pyramid(rng, 1)
    rois = _rois(rng, 24)
    got = pra.multiscale_roi_align([t(f) for f in feats], t(rois[None]), output_size=out_size)[0].numpy()
    frame = [jnp.asarray(f[0]) for f in feats]
    want = np.asarray(jax_roi_align(frame, jnp.asarray(rois), SCALES, output_size=out_size))
    np.testing.assert_allclose(got, want, atol=1e-5)
    pallas = np.asarray(multiscale_roi_align_pallas(frame, jnp.asarray(rois), SCALES, output_size=out_size, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-4)


def test_plain_roi_align_batch_matches_per_frame():
    """A [T, N] batch with a frame per roi (N not a multiple of 4) equals
    pooling each frame on its own: frames must not bleed into each other."""
    rng = np.random.default_rng(1)
    tt, n = 3, 29
    feats = [t(f) for f in _pyramid(rng, tt)]
    rois = t(np.stack([_rois(rng, n - 5) for _ in range(tt)]))
    got = pra.multiscale_roi_align(feats, rois, output_size=7)
    assert got.shape == (tt, n, 7, 7, 8)
    for f in range(tt):
        want = pra.multiscale_roi_align([fl[f : f + 1] for fl in feats], rois[f : f + 1], output_size=7)
        np.testing.assert_array_equal(got[f].numpy(), want[0].numpy())
        jwant = np.asarray(jax_roi_align([jnp.asarray(fl[f].numpy()) for fl in feats], jnp.asarray(rois[f].numpy()), SCALES))
        np.testing.assert_allclose(got[f].numpy(), jwant, atol=1e-5)


def test_plain_roi_align_bf16_keeps_dtype():
    rng = np.random.default_rng(2)
    feats = [t(f).to(torch.bfloat16) for f in _pyramid(rng, 2)]
    rois = t(np.stack([_rois(rng, 11) for _ in range(2)]))
    got = pra.multiscale_roi_align(feats, rois, output_size=14)
    want = pra.multiscale_roi_align([f.float() for f in feats], rois, output_size=14)
    assert got.dtype == torch.bfloat16
    # bf16 weights and products: a few bf16 roundings of values of order 1.
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=5e-2)


def _axis_tables(lo, hi, frac, valid, out_size):
    """Test-side transcription of the kernel's tables of one axis of one roi
    (`csrc/roi_align.cu`, step 1, a lane per sample): the largest valid tap
    before each sample, which candidate taps are new, their ranks by count,
    each bin's run of at most 4 distinct taps and its merged f32 weights.
    Returns the distinct taps and a dense [out, taps] weight matrix."""
    n = 2 * out_size
    lo, hi = [int(v) for v in lo], [int(v) for v in hi]
    before = [-1] + list(np.maximum.accumulate([hi[s] if valid[s] else -1 for s in range(n)]))[:-1]
    new_lo = [bool(valid[s]) and lo[s] > before[s] for s in range(n)]
    new_hi = [bool(valid[s]) and hi[s] > lo[s] and hi[s] > before[s] for s in range(n)]
    rank_hi = [sum(new_lo[: s + 1]) + sum(new_hi[: s + 1]) - 1 for s in range(n)]
    rank_lo = [rank_hi[s] - new_hi[s] - (before[s] > lo[s]) for s in range(n)]
    taps = [0] * (sum(new_lo) + sum(new_hi))
    for s in range(n):
        if new_lo[s]:
            taps[rank_lo[s]] = lo[s]
        if new_hi[s]:
            taps[rank_hi[s]] = hi[s]
    assert taps == sorted({v for s in range(n) if valid[s] for v in (lo[s], hi[s])}) and len(taps) <= 4 * out_size
    for s in range(n):
        if valid[s]:
            assert taps[rank_lo[s]] == lo[s] and taps[rank_hi[s]] == hi[s]
    weights = np.zeros((out_size, len(taps)), np.float32)
    for b in range(out_size):
        samples = [s for s in (2 * b, 2 * b + 1) if valid[s]]
        if not samples:
            continue
        start = rank_lo[samples[0]]
        end = rank_hi[samples[-1]] + 1
        assert end - start <= 4
        for s in samples:
            assert start <= rank_lo[s] <= rank_hi[s] < end
            weights[b, rank_lo[s]] += np.float32(0.5) * (np.float32(1) - frac[s])
            weights[b, rank_hi[s]] += np.float32(0.5) * frac[s]
    return taps, weights


@pytest.mark.parametrize("out_size", [7, 14])
def test_separable_tables_match_plain_roi_align(out_size):
    """The kernel's algebra on the CPU in f32: distinct taps per axis,
    per-bin runs, merged weights and Wy . F . Wx^T, against the plain
    version at atol 1e-5 + rtol 1e-5 (only the sum order differs)."""
    rng = np.random.default_rng(6)
    frames = 2
    feats, rois = edge_case_batch(rng, frames, c=8)
    want = pra.multiscale_roi_align_plain([t(f) for f in feats], t(rois), output_size=out_size)
    grid = pra.sample_grid([f.shape[1:3] for f in feats], t(rois), output_size=out_size)
    levels = pra.fpn_level_assignment(t(rois).reshape(-1, 4)).numpy()
    g = {k: v.numpy() for k, v in grid.items()}
    got = np.empty(want.shape, np.float32).reshape(-1, out_size, out_size, 8)
    most_taps = 0
    for m in range(rois.shape[0] * rois.shape[1]):
        ty, wy = _axis_tables(g["y0"][m], g["y1"][m], g["ly"][m], g["my"][m], out_size)
        tx, wx = _axis_tables(g["x0"][m], g["x1"][m], g["lx"][m], g["mx"][m], out_size)
        most_taps = max(most_taps, len(ty), len(tx))
        f = feats[levels[m]][m // rois.shape[1]][np.ix_(ty, tx)] if ty and tx else np.zeros((len(ty), len(tx), 8))
        got[m] = np.einsum("pi,ijc,qj->pqc", wy, f.astype(np.float32), wx)
    # The edge cases are really there: a full table, merged clamped taps,
    # invalid samples and empty bins.
    assert most_taps == 4 * out_size
    assert (g["my"] & (g["y0"] == g["y1"])).any() and (g["mx"] & (g["x0"] == g["x1"])).any()
    assert not g["my"].all() and not g["mx"].all()
    assert (~g["my"].reshape(-1, out_size, 2).any(-1)).any()
    torch.testing.assert_close(t(got).reshape(want.shape), want, atol=1e-5, rtol=1e-5)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    """Input checks run before any build or launch, so they are testable
    without the card."""
    rng = np.random.default_rng(3)
    feats = [t(f) for f in _pyramid(rng, 2)]
    rois = t(np.stack([_rois(rng, 3) for _ in range(2)]))
    with pytest.raises(ValueError, match="output_size"):
        pra._check_cuda_inputs(feats, rois, SCALES, 9, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pra._check_cuda_inputs([f.half() for f in feats], rois, SCALES, 7, 2)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        pra._check_cuda_inputs([f.transpose(1, 2) for f in feats], rois, SCALES, 7, 2)
    with pytest.raises(ValueError, match="float32"):
        pra._check_cuda_inputs(feats, rois.double(), SCALES, 7, 2)
    with pytest.raises(ValueError, match="4 FPN levels"):
        pra._check_cuda_inputs(feats[:3], rois, SCALES[:3], 7, 2)
    # 16-byte channel vectors: C a multiple of 4 in f32, of 8 in bf16.
    with pytest.raises(ValueError, match="multiple of 4"):
        pra._check_cuda_inputs([f[..., :6] .contiguous() for f in feats], rois, SCALES, 7, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        pra._check_cuda_inputs([f[..., :4].contiguous().bfloat16() for f in feats], rois, SCALES, 7, 2)
    # Level data 16-byte aligned: a contiguous view 4 bytes into its storage.
    shifted = [torch.empty(f.numel() + 1)[1:].view(f.shape).copy_(f) for f in feats]
    with pytest.raises(ValueError, match="16-byte aligned"):
        pra._check_cuda_inputs(shifted, rois, SCALES, 7, 2)
    pra._check_cuda_inputs(feats, rois, SCALES, 14, 2)
    pra._check_cuda_inputs([f[..., :4].contiguous() for f in feats], rois, SCALES, 7, 2)
    # Precomputed levels: int32, one per roi, contiguous, on the rois' device.
    levels = pra.fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
    for bad in (levels.long(), levels[:-1], levels.reshape(2, -1), levels.repeat_interleave(2)[::2]):
        with pytest.raises(ValueError, match="levels must be"):
            pra.launch_kernel(feats, rois, bad, SCALES, 7)


def test_encode_boxes_takes_frame_batches():
    """[n, P, 4] boxes, as the losses give them, against JAX per frame."""
    rng = np.random.default_rng(9)
    ref = np.stack([random_boxes(rng, 20) for _ in range(3)])
    props = np.stack([random_boxes(rng, 20) for _ in range(3)])
    w = (10.0, 10.0, 5.0, 5.0)
    got = pboxes.encode_boxes(t(ref), t(props), w)
    assert got.shape == (3, 20, 4)
    for f in range(3):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(jboxes.encode_boxes(ref[f], props[f], w)), rtol=1e-5, atol=1e-5)


def test_interp_matrix_matches_jax():
    """Rois across, on and off the level's edges, and sub-pixel ones."""
    rng = np.random.default_rng(10)
    starts = np.concatenate([rng.uniform(-20, 60, 30), [-1.2, 47.9, 0.0]]).astype(np.float32)
    bins = np.concatenate([rng.uniform(0.05, 9, 30), [0.5, 0.3, 1 / 7]]).astype(np.float32)
    for out_size in (7, 14):
        got = pra.interp_matrix_1d(t(starts), t(bins), 48, out_size, 2)
        want = np.asarray(jax_interp_matrix_1d(jnp.asarray(starts), jnp.asarray(bins), 48, out_size, 2, jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _grad_inputs(rng, frames, out_size, edge_cases):
    if edge_cases:
        feats, rois = edge_case_batch(rng, frames, c=8)
    else:
        feats = _pyramid(rng, frames)
        rois = np.stack([_rois(rng, 19) for _ in range(frames)])
    g = rng.normal(size=(*rois.shape[:2], out_size, out_size, feats[0].shape[-1])).astype(np.float32)
    return feats, rois, g


def _backward(feats, rois, g, out_size):
    """The pool's gradient through `multiscale_roi_align` (its autograd
    Function, here the plain backward)."""
    levels = [t(f).requires_grad_(True) for f in feats]
    pooled = pra.multiscale_roi_align(levels, t(rois), output_size=out_size)
    return torch.autograd.grad(pooled, levels, t(g))


@pytest.mark.parametrize("out_size", [7, 14])
def test_plain_backward_matches_jax_vjp(out_size):
    """Against `jax.vjp` of `multiscale_roi_align_mmgrad` (the JAX custom
    VJP the train step uses), frame by frame, rel 1e-5 of each level's
    largest gradient."""
    rng = np.random.default_rng(11)
    feats, rois, g = _grad_inputs(rng, 2, out_size, edge_cases=False)
    got = _backward(feats, rois, g, out_size)

    @jax.jit
    def jax_backward(frame, r, gf):
        pool = lambda *fs: multiscale_roi_align_mmgrad(list(fs), r, SCALES, output_size=out_size)  # noqa: E731
        return jax.vjp(pool, *frame)[1](gf)

    for f in range(2):
        want_levels = jax_backward([jnp.asarray(fl[f]) for fl in feats], jnp.asarray(rois[f]), jnp.asarray(g[f]))
        for gl, wl in zip(got, want_levels):
            want = np.asarray(wl)
            assert np.abs(gl[f].numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("out_size", [7, 14])
def test_plain_backward_matches_autograd_of_plain_forward(out_size):
    """Against torch autograd through the gather of
    `multiscale_roi_align_plain`, on the kernel's edge-case rois (clamped,
    sub-pixel, zero-area, off-canvas, >20:1, 28 and 56 taps a side): rel
    1e-5. The rois get no gradient."""
    rng = np.random.default_rng(12)
    feats, rois, g = _grad_inputs(rng, 2, out_size, edge_cases=True)
    got = _backward(feats, rois, g, out_size)
    levels = [t(f).requires_grad_(True) for f in feats]
    want = torch.autograd.grad(pra.multiscale_roi_align_plain(levels, t(rois), output_size=out_size), levels, t(g))
    for gl, wl in zip(got, want):
        assert gl.shape == wl.shape and gl.dtype == wl.dtype
        assert float((gl - wl).abs().max()) <= 1e-5 * float(wl.abs().max())
    r = t(rois).requires_grad_(True)
    pra.multiscale_roi_align([t(f).requires_grad_(True) for f in feats], r, output_size=out_size).sum().backward()
    assert r.grad is None


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    """The backward wrapper's checks run before any build or launch."""
    rng = np.random.default_rng(13)
    feats, rois, g = _grad_inputs(rng, 2, 7, edge_cases=False)
    hws = [f.shape[1:3] for f in feats]
    rois, g = t(rois), t(g)
    with pytest.raises(ValueError, match="output_size"):
        pra.roi_align_backward_cuda(g, rois, hws, output_size=9)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pra.roi_align_backward_cuda(g.half(), rois, hws)
    with pytest.raises(ValueError, match="g must be"):
        pra.roi_align_backward_cuda(g[:, :-1], rois, hws)
    with pytest.raises(ValueError, match="g must be"):
        pra.roi_align_backward_cuda(g.transpose(2, 3), rois, hws)
    with pytest.raises(ValueError, match="rois must be"):
        pra.roi_align_backward_cuda(g, rois.double(), hws)
    with pytest.raises(ValueError, match="4 FPN levels"):
        pra.roi_align_backward_cuda(g, rois, hws[:3], SCALES[:3])
    # The tile is stored as 16-byte channel vectors: C a multiple of 4 in
    # f32, of 8 in bf16 (g here has 8 channels), and g 16-byte aligned.
    with pytest.raises(ValueError, match="multiple of 4"):
        pra.roi_align_backward_cuda(g[..., :6].contiguous(), rois, hws)
    with pytest.raises(ValueError, match="multiple of 8"):
        pra.roi_align_backward_cuda(g[..., :4].contiguous().bfloat16(), rois, hws)
    shifted = torch.empty(g.numel() + 1)[1:].view(g.shape).copy_(g)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pra.roi_align_backward_cuda(shifted, rois, hws)
    levels = pra.fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
    for bad in (levels.long(), levels[:-1]):
        with pytest.raises(ValueError, match="levels must be"):
            pra.roi_align_backward_cuda(g, rois, hws, levels=bad)
