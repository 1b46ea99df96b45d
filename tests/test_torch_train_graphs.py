"""The port's training step on its way to a CUDA graph, on the CPU at a tiny
size (60x100 frames, min 64, max 128, SlowFast 3-3, the tiny detection
config, f32): the batch staged in host buffers is the batch
`torch.as_tensor` made before; the constants cached once per device in
`project_masks_on_boxes` and `interp_matrix_1d` give the per-call
constants' outputs bit for bit; a warm step builds no tensor from host
data; the fixed gradients and momentum buffers, zeroed in place, step
exactly as freed ones did (so every parity test with JAX stands as it
was: `tests/test_torch_train.py`, `test_torch_drivers.py`); the schedule
fills the device rate in place and a restored rate is bound again; graphs
are refused off the card; the step key and the bookkeeping of weight,
gradient and buffer addresses in `train/graphs.py`; and launches onto a
captured stream from another thread are recorded. The graphs themselves
run only on the card: tests/test_torch_cuda.py holds them against the eager
path there."""
import io
import sys
import threading

import numpy as np
import pytest
import torch

from slowfast_vos_tpu_torch import data
from slowfast_vos_tpu_torch.models import heads
from slowfast_vos_tpu_torch.models.config import DetectionConfig
from slowfast_vos_tpu_torch.models.pipeline import Pipeline, build_pipeline, init_weights
from slowfast_vos_tpu_torch.ops import cuda_build, roi_align
from slowfast_vos_tpu_torch.train import Trainer, graphs
from slowfast_vos_tpu_torch.train.pretrain import warmup_step_lr
from slowfast_vos_tpu_torch.train.train_step import stage_batch
from slowfast_vos_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

torch.set_num_threads(2)  # the tier-1 run has 6 workers on 8 cores

HW = (60, 100)
CFG = DetectionConfig(
    rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32, rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=32,
    box_batch_size_per_image=32, mask_train_rois=8, detections_per_img=5, max_gt=3,
)


def tiny_pipeline(seed=0, hw=HW):
    pipe, model = build_pipeline(3, 3, dtype=torch.float32, device="cpu", superchunk=4, original_hw=hw,
                                 min_size=64, max_size=128, cfg=CFG)
    init_weights(model, seed=seed)
    return pipe


def windows(n_center=2, float_images=False, hw=HW, seed=3):
    images, ids = data.draw_sequence(np.random.default_rng(seed), 6, *hw, 2)
    out = list(data.train_windows(data.sequence_arrays(images, ids, CFG.max_gt), fast=3, n_center=n_center))
    if float_images:
        out = [dict(b, images=(b["images"] / 255.0).astype(np.float32)) for b in out]
    return out


@pytest.mark.parametrize("float_images", [False, True], ids=["uint8", "float32"])
def test_staged_batch_equals_as_tensor(float_images):
    """Every field of a window, uint8 or float32 images, staged into a host
    buffer: the values and dtype `torch.as_tensor` gave, in a copy; a tensor
    already on the device passes as it is."""
    batch = windows(float_images=float_images)[1]
    staged = stage_batch(batch, torch.device("cpu"))
    assert staged.keys() == batch.keys()
    for k, v in batch.items():
        want = torch.as_tensor(v)
        assert staged[k].dtype == want.dtype and torch.equal(staged[k], want), k
        assert staged[k].data_ptr() != want.data_ptr(), k
    assert staged["images"].dtype == (torch.float32 if float_images else torch.uint8)
    on_device = {k: torch.as_tensor(v) for k, v in batch.items()}
    again = stage_batch(on_device, torch.device("cpu"))
    assert all(again[k] is on_device[k] for k in batch)


def _fresh_constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def test_cached_constants_give_the_mask_targets_bit_for_bit(monkeypatch):
    """`project_masks_on_boxes` (through `interp_matrix_1d`) and the plain
    RoIAlign backward (the CPU's) with their constants built once per
    device against the same constants built at every call, as before."""
    rng = np.random.default_rng(0)
    masks = torch.from_numpy((rng.uniform(size=(2, 3, 64, 112)) > 0.5).astype(np.float32))
    xy = rng.uniform(-4, 60, (2, 8, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(0.5, 50, (2, 8, 2))], -1).astype(np.float32))
    gt = torch.from_numpy(rng.integers(0, 3, (2, 8)))
    g = torch.from_numpy(rng.normal(size=(2, 8, 7, 7, 8)).astype(np.float32))
    hws = [(16, 28), (8, 14), (4, 7), (2, 4)]

    def outputs():
        return [heads.project_masks_on_boxes(masks, gt, boxes, 28),
                roi_align.interp_matrix_1d(boxes[0, :, 0], boxes[0, :, 2] - boxes[0, :, 0], 112, 14, 2),
                *roi_align.multiscale_roi_align_backward_plain(g, boxes, hws, output_size=7)]

    cached = outputs()
    for module in (heads, roi_align):
        monkeypatch.setattr(module, "device_constant", _fresh_constant)
    assert all(torch.equal(a, b) for a, b in zip(outputs(), cached))
    assert all(x.abs().sum() > 0 for x in cached[:3])


def test_warm_step_builds_no_tensor_from_host_data(monkeypatch):
    """Once its constants exist, a step (gradient and update) calls neither
    `torch.tensor` nor `torch.as_tensor`: on the card each would be a copy
    from pageable host memory and a host synchronize, and an error inside a
    graph capture."""
    tr = Trainer(tiny_pipeline())
    batch = windows()[1]
    tr.step(batch)
    calls = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _real=real, _name=name, **kw: calls.append(_name) or _real(*a, **kw))
    tr.step(batch)
    assert calls == []


@pytest.mark.parametrize("accumulate", [1, 2])
def test_fixed_gradients_and_buffers_step_as_freed_ones(accumulate):
    """Gradients and momentum buffers that exist from the start and are
    zeroed in place (the graphs' fixed addresses) against the former
    behaviour, gradients freed after each update and buffers made by the
    first: the same weights, statistics and buffers bit for bit over 3
    calls, and the same tensors throughout."""
    batches = windows()[:3]
    start = tiny_pipeline().model.state_dict()

    def run(freed):
        pipe = tiny_pipeline()
        pipe.model.load_state_dict(start)
        tr = Trainer(pipe, accumulate=accumulate)
        if freed:
            tr.optimizer.state.clear()
            for p in tr.params.values():
                p.grad = None
            tr.device_update = lambda: (tr.optimizer.step(), tr.optimizer.zero_grad(set_to_none=True))
        fixed = [(p.grad, tr.optimizer.state[p].get("momentum_buffer")) for p in tr.params.values()]
        for b in batches:
            tr.step(b)
        if not freed:
            assert fixed == [(p.grad, tr.optimizer.state[p]["momentum_buffer"]) for p in tr.params.values()]
            assert all(not p.grad.any() for p in tr.params.values()) == (len(batches) % accumulate == 0)
        return pipe.model.state_dict(), [tr.optimizer.state[p]["momentum_buffer"] for p in tr.params.values()]

    (got, got_bufs), (want, want_bufs) = run(False), run(True)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert all(torch.equal(a, b) for a, b in zip(got_bufs, want_bufs))


def test_schedule_fills_the_device_rate_in_place(tmp_path):
    """A schedule acts on `Trainer.lr` in place (a graph reads it there),
    the rate at update k being the schedule's at k; a restored optimizer
    state's rate is bound to the trainer's tensor again at the next
    update."""
    schedule = warmup_step_lr(1e-3, 2, warmup_iters=3)
    tr = Trainer(tiny_pipeline(), lr=schedule)
    rate, group = tr.lr, tr.optimizer.param_groups[0]
    seen = []
    for b in windows()[:3]:
        seen.append(float(tr.lr))
        tr.step(b)
    assert seen == pytest.approx([schedule(k) for k in range(3)], rel=1e-6)
    assert tr.lr is rate and group["lr"] is rate
    save_checkpoint(str(tmp_path / "ck.pt"), tr)
    fresh = Trainer(tiny_pipeline(), lr=schedule)
    restore_checkpoint(str(tmp_path / "ck.pt"), fresh)
    assert fresh.optimizer.param_groups[0]["lr"] is not fresh.lr
    fresh.apply_update()
    assert fresh.optimizer.param_groups[0]["lr"] is fresh.lr
    assert float(fresh.lr) == pytest.approx(schedule(4), rel=1e-6) and float(tr.lr) == pytest.approx(schedule(3), rel=1e-6)


def test_graphs_are_refused_off_the_card():
    pipe = tiny_pipeline()
    assert Trainer(pipe).graphs is None  # the default on the CPU: eager
    assert Trainer(pipe, graphs=False).graphs is None
    with pytest.raises(ValueError, match="CUDA graphs run on a CUDA device"):
        Trainer(pipe, graphs=True)


def test_step_key_tells_the_graphs_apart():
    """The window length, the gt count, uint8 or float32 images, caller
    draws or none, `n_center` and the pipeline each give another key; the
    same shapes on the same pipeline give the same one."""
    pipe, other = tiny_pipeline(), tiny_pipeline(hw=(64, 96))
    dev = torch.device("cpu")

    def key(batch, p=pipe, draws=None, n_center=2):
        return graphs.step_key(p, stage_batch(batch, dev), draws, n_center)

    two, one = windows(), windows(n_center=1)
    base = key(two[0])
    assert key(two[1]) == base
    fewer_gt = {k: (v[:, :2] if k in ("boxes", "labels", "gt_valid", "masks") else v) for k, v in two[0].items()}
    draws = Trainer(pipe).make_draws(CFG.max_gt)
    others = [key(one[0], n_center=1), key(fewer_gt), key(windows(float_images=True)[0]), key(two[0], draws=draws),
              key(two[0], p=other), key(two[0], n_center=1)]
    assert len({base, *others}) == 1 + len(others)


def test_addresses_drop_the_graphs_when_a_tensor_moves():
    """The runner's bookkeeping on the CPU (no capture): steps, whose
    updates and zeroing are in place, keep the graphs; a replaced gradient,
    parameter or buffer, a restored optimizer state (new momentum buffers)
    and a rate that moved each drop them all."""
    pipe = tiny_pipeline()
    tr = Trainer(pipe)
    runner = graphs.TrainStepGraphs(tr)
    runner.check_addresses()

    def captured():
        runner.graphs[("key",)] = "graph"
        runner.update = "update"
        runner.check_addresses()
        return ("key",) in runner.graphs and runner.update == "update"

    assert captured()
    tr.step(windows()[1])
    runner.check_addresses()
    assert ("key",) in runner.graphs

    name, p = next(iter(tr.params.items()))
    p.grad = torch.zeros_like(p)
    runner.check_addresses()
    assert runner.graphs == {} and runner.update is None

    assert captured()
    saved = io.BytesIO()
    torch.save(tr.optimizer.state_dict(), saved)
    saved.seek(0)
    tr.optimizer.load_state_dict(torch.load(saved))
    runner.check_addresses()
    assert runner.graphs == {}

    assert captured()
    head = pipe.model.roi_heads.box_predictor.cls_score
    head.weight = torch.nn.Parameter(head.weight.detach().clone())
    runner.check_addresses()
    assert runner.graphs == {}

    assert captured()
    pipe.model.slow_fast.bn_s1.running_mean = pipe.model.slow_fast.bn_s1.running_mean.clone()
    runner.check_addresses()
    assert runner.graphs == {}

    assert captured()
    tr.lr = tr.lr.clone()
    runner.check_addresses()
    assert runner.graphs == {}


def test_a_second_canvas_trains_through_its_own_key():
    """`use_pipeline` onto another canvas over the same model: the key
    changes with the pipeline, and the step runs there."""
    pipe = tiny_pipeline()
    other = Pipeline(pipe.model, tiny_pipeline(hw=(64, 96)).transform, superchunk=4)
    tr = Trainer(pipe)
    keys = set()
    for p, b in ((pipe, windows()[1]), (other, windows(hw=(64, 96))[1])):
        tr.use_pipeline(p)
        keys.add(graphs.step_key(p, stage_batch(b, p.device), None, tr.n_center))
        assert all(torch.isfinite(v) for v in tr.step(b).values())
    assert len(keys) == 2 and tr.calls == 2


def test_launches_onto_a_captured_stream_count_per_replay():
    """While a graph is captured on a stream, launches onto that stream from
    other threads (autograd's device thread runs the backward) go into the
    graph's count; launches onto other streams count as usual, and the
    stream counts as usual again after the capture. Threads and a short
    switch interval stress the shared counter."""
    key, stream = ("test", "stream"), 0x5EED
    before = cuda_build.launches[key]

    def launch(streams, n=200):
        threads = [threading.Thread(target=lambda s=s: [cuda_build.count_launch(key, s) for _ in range(n)])
                   for s in streams]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cuda_build.recording_launches(stream) as rec:
            launch([stream, stream + 1] * 8)
            cuda_build.count_launch(key)  # the capturing thread's own launch, on any stream
        launch([stream] * 4)
    finally:
        sys.setswitchinterval(interval)
    assert dict(rec) == {key: 8 * 200 + 1}
    assert cuda_build.launches[key] == before + 12 * 200
    cuda_build.count_replay(rec)
    assert cuda_build.launches[key] == before + 20 * 200 + 1
    del cuda_build.launches[key]
