"""The PyTorch port's Mask R-CNN fine-tune against the JAX package's
`train_maskrcnn`, on the same tiny 2017 train tree (6 frames, 60x100,
batches of 2 frames, f32 on the CPU) and the same weights, with the
schedule, the frozen conv1/layer1, the checkpoint and the RPN proposal
dump; and the pipeline paths the drivers add (`use_slow_fast=False`,
`infer_sequence(instance_masks=True)`, `compute_sequence_features`).

As in `tests/test_torch_drivers.py`, the port's `Trainer.make_draws`
returns the draws the JAX driver makes from its key sequence, and the flips
come from the same numpy generator, so the per-step losses agree within
relative 1e-4, with layers 2-4 of the backbone, the FPN and the RPN
training. The learning rate in force at update k is the JAX schedule's at
k (relative 1e-6: JAX computes it in f32)."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from torch_port_common import TINY_CFG, TINY_HW, TINY_KW, jax_draws, logged, tiny_pipelines, tiny_trees
from slowfast_vos_tpu.train.pretrain import extract_rpn_proposals as jax_extract_rpn_proposals
from slowfast_vos_tpu.train.pretrain import train_maskrcnn as jax_train_maskrcnn
from slowfast_vos_tpu.train.pretrain import warmup_step_lr as jax_warmup_step_lr
from slowfast_vos_tpu_torch.eval.glue import extract_masks
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline
from slowfast_vos_tpu_torch.train import Trainer
from slowfast_vos_tpu_torch.train.pretrain import (
    build_maskrcnn_pipeline,
    extract_rpn_proposals,
    train_maskrcnn,
    warmup_step_lr,
)
from slowfast_vos_tpu_torch.utils.checkpoint import load_checkpoint

SEED = 63
LOSS_RTOL = 1e-4
EPOCHS, STEPS = 2, 2


@pytest.mark.parametrize("kw", [
    dict(base_lr=1e-3, steps_per_epoch=5, warmup_iters=4),
    dict(base_lr=5e-3, steps_per_epoch=3, warmup_iters=1, step_size_epochs=2, gamma=0.5),
    dict(base_lr=1e-2, steps_per_epoch=7, warmup_iters=0),
    dict(base_lr=2e-4, steps_per_epoch=2, warmup_iters=30, step_size_epochs=1),
])
def test_warmup_step_lr_matches_jax(kw):
    base_lr, spe = kw.pop("base_lr"), kw.pop("steps_per_epoch")
    got, want = warmup_step_lr(base_lr, spe, **kw), jax_warmup_step_lr(base_lr, spe, **kw)
    for step in range(51):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step
    assert got(0) == pytest.approx(base_lr / 1000)  # warmup_iters 0 counts as 1


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return tiny_trees(tmp_path_factory)


@pytest.fixture(scope="module")
def runs(roots, tmp_path_factory):
    train_root, _ = roots
    jpipe, variables, pipe, state_dict = tiny_pipelines(slow=1, fast=1, seed=3, use_slow_fast=False)
    kw = dict(davis_root=train_root, epochs=EPOCHS, max_steps_per_epoch=STEPS, batch_size=2, seed=SEED)
    jax_out = str(tmp_path_factory.mktemp("jax_pre"))
    _, jax_history = jax_train_maskrcnn(jpipe, output_dir=jax_out, variables=variables, **kw)

    def jax_step_keys():
        key = jax.random.PRNGKey(SEED)
        while True:
            key, sub = jax.random.split(key)
            yield sub

    keys, lrs, step = jax_step_keys(), [], Trainer.step

    def draws_from_jax(self, num_gt):
        return jax_draws(next(keys), self.n_center, self.num_anchors, self.pipe.cfg.rpn_post_nms_top_n_train + num_gt)

    def recording_step(self, batch, draws=None):
        lrs.append(float(self.optimizer.param_groups[0]["lr"]))  # a device tensor the schedule fills in place
        return step(self, batch, draws)

    port_out = str(tmp_path_factory.mktemp("port_pre"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "make_draws", draws_from_jax)
        mp.setattr(Trainer, "step", recording_step)
        trainer, history = train_maskrcnn(pipe, output_dir=port_out, state_dict=state_dict, **kw)
    yield {"jax": (jax_out, jax_history, variables, jpipe), "port": (port_out, history), "trainer": trainer,
           "state_dict": state_dict, "lrs": lrs}
    for out in (jax_out, port_out):  # full-model checkpoints: none is kept after the module
        shutil.rmtree(out, ignore_errors=True)


def test_step_losses_and_history_match_jax(runs):
    jax_out, jax_history, *_ = runs["jax"]
    port_out, history = runs["port"]
    want = logged(os.path.join(jax_out, "logs", "maskrcnn-*.jsonl"), "pretrain/loss")
    got = logged(os.path.join(port_out, "logs", "maskrcnn-*.jsonl"), "pretrain/loss")
    assert len(got) == len(want) == EPOCHS * STEPS
    for g, w in zip(got, want):
        assert np.isfinite(g) and abs(g - w) <= LOSS_RTOL * abs(w), (got, want)
    assert [sorted(h) for h in history] == [sorted(h) for h in jax_history]
    assert [h["epoch"] for h in history] == [h["epoch"] for h in jax_history] == list(range(EPOCHS))
    for g, w in zip(history, jax_history):
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"])


def test_learning_rate_per_update_is_the_jax_schedule(runs):
    """One optimizer step per call (accumulate 1): the rate in force at
    update k is the schedule's at k, warmup first (base / 1000)."""
    sched = jax_warmup_step_lr(1e-3, STEPS, warmup_iters=min(1000, STEPS - 1) or 1)
    assert runs["lrs"] == pytest.approx([float(sched(k)) for k in range(EPOCHS * STEPS)], rel=1e-6)
    assert runs["lrs"][0] == pytest.approx(1e-6)
    assert runs["trainer"].scheduler.last_epoch == EPOCHS * STEPS


def test_frozen_stem_and_layer1_stay_bit_identical(runs):
    """trainable_backbone_layers=3: conv1 and layer1 (and every
    FrozenBatchNorm buffer) are bit-identical; layers 2-4, the FPN, the RPN
    and the heads moved."""
    start, model = runs["state_dict"], runs["trainer"].model
    params = dict(model.named_parameters())
    after = model.state_dict()
    assert not any(k.startswith("slow_fast.") for k in after)
    frozen = ("backbone.body.conv1.", "backbone.body.layer1.")
    moved = 0
    for k, v in start.items():
        if k not in params or k.startswith(frozen):
            assert torch.equal(after[k], v), k
        elif v.dim() > 1:
            assert not torch.equal(after[k], v), k
            moved += 1
    assert moved > 50


def test_checkpoint_each_epoch(runs):
    port_out, _ = runs["port"]
    payload = load_checkpoint(os.path.join(port_out, "maskrcnn_model.pt"))
    assert payload["meta"] == {"epoch": EPOCHS - 1} and payload["calls"] == EPOCHS * STEPS
    assert payload["scheduler"]["last_epoch"] == EPOCHS * STEPS
    for k, v in runs["trainer"].model.state_dict().items():
        assert torch.equal(payload["model"][k].to(v.device), v), k


def test_rpn_proposal_dump_matches_jax(runs, roots, tmp_path):
    """`extract_rpn_proposals` from the same starting weights: the same
    sequences and frames, valid flags equal, proposals within 0.05 px (the
    forward's tolerance in tests/test_torch_pipeline.py)."""
    _, eval_root = roots
    _, _, variables, jpipe = runs["jax"]
    pipe, model = build_maskrcnn_pipeline(TINY_HW, min_size=64, max_size=128, cfg=TINY_CFG, dtype=torch.float32, device="cpu")
    model.load_state_dict(runs["state_dict"], strict=True)
    kw = dict(davis_root=eval_root, subset="val", year="2016")
    got = np.load(extract_rpn_proposals(pipe, output_path=str(tmp_path / "port.npz"), **kw))
    want = np.load(jax_extract_rpn_proposals(jpipe, variables, output_path=str(tmp_path / "jax.npz"), **kw))
    assert sorted(got.files) == sorted(want.files) == ["synth00/proposals", "synth00/valid"]
    np.testing.assert_array_equal(got["synth00/valid"], want["synth00/valid"])
    assert got["synth00/proposals"].shape == (6, TINY_CFG.rpn_post_nms_top_n_test, 4)
    valid = want["synth00/valid"]
    np.testing.assert_allclose(got["synth00/proposals"][valid], want["synth00/proposals"][valid], atol=0.05)


def test_sequence_features_carry_the_zero_halo():
    pipe, model = build_pipeline(1, 3, dtype=torch.float32, device="cpu", superchunk=4, **TINY_KW)
    images = np.random.default_rng(0).integers(0, 256, (6, *TINY_HW, 3), dtype=np.uint8)
    feats, proposals, pvalid = pipe.compute_sequence_features(images)
    assert [f.shape[0] for f in feats] == [6 + 2] * 4 and proposals.shape[:2] == pvalid.shape == (6, 32)
    for f in feats:
        assert float(f[0].abs().max()) == 0.0 and float(f[-1].abs().max()) == 0.0 and float(f[1].abs().max()) > 0


def test_plain_mask_rcnn_enhance_slices_the_halo():
    """Without SlowFast, `enhance` passes the levels through, less the
    pre-padded halo (JAX `segmentation.py:63-69`)."""
    _, model = build_pipeline(1, 3, dtype=torch.float32, device="cpu", use_slow_fast=False, **TINY_KW)
    feats = [torch.randn(7, 4, 5, 8) for _ in range(5)]
    out = model.enhance(feats, pre_padded=True)
    assert len(out) == 4 and all(torch.equal(o, f[1:6]) for o, f in zip(out, feats))
    assert all(o is f for o, f in zip(model.enhance(feats), feats[:4]))


def test_instance_masks_give_the_same_union(roots, tmp_path):
    """`infer_sequence(instance_masks=True)` returns each detection's pasted
    probabilities, whose union at 0.5 is the default path's union; a
    results tree at another threshold is written from them."""
    _, eval_root = roots
    pipe, model = build_pipeline(1, 3, dtype=torch.float32, device="cpu", superchunk=4, **TINY_KW)
    images = np.random.default_rng(1).integers(0, 256, (6, *TINY_HW, 3), dtype=np.uint8)
    plain = pipe.infer_sequence(images)
    inst = pipe.infer_sequence(images, instance_masks=True)
    for p, q in zip(plain, inst):
        assert q["masks"].shape == (TINY_CFG.detections_per_img, *TINY_HW)
        for k in p:
            np.testing.assert_array_equal(p[k], q[k], err_msg=k)
    extract_masks(pipe, eval_root, str(tmp_path), threshold=0.3)
    assert sorted(os.listdir(tmp_path / "synth00")) == [f"{i:05d}.png" for i in range(6)]
