"""The PyTorch port's unsupervised training driver against the JAX
package's `train_unsupervised`, on the same tiny trees (a 2017 train tree
and a 2016 val tree, 60x100, SlowFast 1-3, f32 on the CPU) and the same
weights (the JAX variables with every leaf redrawn, carried over by
`state_dict_from_flax`).

In the parity test only, the port's `Trainer.make_draws` returns the draws
the JAX driver makes from its key sequence (`PRNGKey(seed)` split once per
step), so both sides sample the same anchors and rois. The per-step losses
of the epoch's 2 windows then agree within relative 1e-4: the first window
runs the same weights, the second the weights after one SGD step, where a
ReLU whose input lies within the libraries' f32 drift of zero can move a
few gradient entries by a few percent (`tests/test_torch_train.py`), a
change of lr x that in the weights and far less in the loss.

Also: the history and its evaluation carry the JAX driver's keys and
epochs, the results tree has one PNG per frame, the checkpoints restore bit
for bit, and `continue_training` resumes at the next epoch."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from torch_port_common import TINY_CFG, jax_draws, logged, tiny_pipelines, tiny_trees
from slowfast_vos_tpu.train.trainer import train_unsupervised as jax_train_unsupervised
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline
from slowfast_vos_tpu_torch.train import Trainer
from slowfast_vos_tpu_torch.train.trainer import train_unsupervised
from slowfast_vos_tpu_torch.utils.checkpoint import load_checkpoint, restore_checkpoint

SEED = 63
LOSS_RTOL = 1e-4
WINDOWS = 2


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return tiny_trees(tmp_path_factory)


@pytest.fixture(scope="module")
def runs(roots, tmp_path_factory):
    """One epoch of 2 windows with an evaluation before and after, by the
    JAX driver (its serial path: tests/conftest.py gives JAX 8 virtual CPU
    devices) and by the port's (given the JAX draws)."""
    train_root, eval_root = roots
    jpipe, variables, pipe, state_dict = tiny_pipelines(slow=1, fast=3, seed=1)
    kw = dict(train_root=train_root, eval_root=eval_root, epochs=1, max_windows_per_epoch=WINDOWS, seed=SEED)
    jax_out = str(tmp_path_factory.mktemp("jax_out"))
    _, jax_history = jax_train_unsupervised(jpipe, output_dir=jax_out, variables=variables, data_parallel=False, **kw)

    keys = iter([])

    def draws_from_jax(self, num_gt):
        return jax_draws(next(keys), self.n_center, self.num_anchors, self.pipe.cfg.rpn_post_nms_top_n_train + num_gt)

    def jax_step_keys():
        key = jax.random.PRNGKey(SEED)
        while True:
            key, sub = jax.random.split(key)
            yield sub

    keys = jax_step_keys()
    port_out = str(tmp_path_factory.mktemp("port_out"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "make_draws", draws_from_jax)
        trainer, history = train_unsupervised(pipe, output_dir=port_out, state_dict=state_dict, **kw)
    yield {"jax": (jax_out, jax_history), "port": (port_out, history), "trainer": trainer, "pipe": pipe}
    for out in (jax_out, port_out):  # full-model checkpoints: none is kept after the module
        shutil.rmtree(out, ignore_errors=True)


def test_step_losses_match_jax(runs):
    jax_out, _ = runs["jax"]
    port_out, _ = runs["port"]
    want = logged(os.path.join(jax_out, "logs", "train-*.jsonl"), "train/batch_loss")
    got = logged(os.path.join(port_out, "logs", "train-*.jsonl"), "train/batch_loss")
    assert len(got) == len(want) == WINDOWS
    for g, w in zip(got, want):
        assert np.isfinite(g) and abs(g - w) <= LOSS_RTOL * abs(w), (got, want)


def test_history_has_the_jax_keys_and_epochs(runs):
    (_, want), (_, got) = runs["jax"], runs["port"]
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [0]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["eval"].keys() == w["eval"].keys()
        assert 0.0 <= g["eval"]["jf"] <= 1.0 and g["eval"]["jf"] == g["eval"]["J&F-Mean"]
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"])
    for out in (runs["jax"][0], runs["port"][0]):
        assert len(logged(os.path.join(out, "logs", "train-*.jsonl"), "eval/jf")) == 2  # sanity eval + epoch 0


def test_results_tree_has_one_png_per_frame(runs, roots):
    port_out, _ = runs["port"]
    res = os.path.join(port_out, "results", "unsupervised", "slowfast_1-3", "synth00")
    assert sorted(os.listdir(res)) == [f"{i:05d}.png" for i in range(6)]


def test_checkpoints_restore_bitwise(runs):
    """ckpt_last and ckpt_best (one epoch: the same state) hold the trained
    weights and SGD momentum buffers; a fresh trainer restores them bit for
    bit."""
    port_out, _ = runs["port"]
    trainer = runs["trainer"]
    for name in ("ckpt_last.pt", "ckpt_best.pt"):
        path = os.path.join(port_out, name)
        payload = load_checkpoint(path)
        assert payload["meta"]["epoch"] == 0 and payload["calls"] == WINDOWS
        pipe, _ = build_pipeline(1, 3, dtype=torch.float32, device="cpu", original_hw=(60, 100), min_size=64, max_size=128, cfg=TINY_CFG)
        fresh = Trainer(pipe)
        meta = restore_checkpoint(path, fresh)
        assert meta == payload["meta"] and fresh.calls == trainer.calls
        for (k, v), w in zip(trainer.model.state_dict().items(), fresh.model.state_dict().values()):
            assert torch.equal(v, w), k
        assert fresh.params.keys() == trainer.params.keys()
        for k, p in trainer.params.items():
            assert torch.equal(trainer.optimizer.state[p]["momentum_buffer"], fresh.optimizer.state[fresh.params[k]]["momentum_buffer"]), k
    assert "jf" in load_checkpoint(os.path.join(port_out, "ckpt_best.pt"))["meta"]


def test_continue_training_resumes_at_the_next_epoch(runs, roots):
    """A second call with continue_training and epochs=2 runs only epoch 1,
    from ckpt_last's weights and momentum."""
    train_root, eval_root = roots
    port_out, _ = runs["port"]
    pipe = runs["pipe"]
    trained = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    _, history = train_unsupervised(
        pipe, train_root=train_root, eval_root=eval_root, output_dir=port_out, epochs=2,
        max_windows_per_epoch=WINDOWS, seed=SEED, continue_training=True, state_dict=trained,
    )
    assert [h["epoch"] for h in history] == [1]
    assert np.isfinite(history[0]["loss"]) and history[0]["eval"] is not None
    payload = load_checkpoint(os.path.join(port_out, "ckpt_last.pt"))
    assert payload["meta"] == {"epoch": 1} and payload["calls"] == 2 * WINDOWS
    _, again = train_unsupervised(
        pipe, train_root=train_root, eval_root=eval_root, output_dir=port_out, epochs=2,
        max_windows_per_epoch=WINDOWS, seed=SEED, continue_training=True, state_dict=trained,
    )
    assert again == []


def test_no_eval_saves_best_every_epoch(roots, tmp_path):
    """Without an evaluation root the history's eval is None and ckpt_best
    follows ckpt_last; seeded random weights stand in for a state dict."""
    train_root, _ = roots
    pipe, _ = build_pipeline(1, 3, dtype=torch.float32, device="cpu", original_hw=(60, 100), min_size=64, max_size=128, cfg=TINY_CFG)
    try:
        _, history = train_unsupervised(pipe, train_root=train_root, output_dir=str(tmp_path), epochs=1,
                                        max_windows_per_epoch=1)
        assert [(h["epoch"], h["eval"]) for h in history] == [(0, None)]
        best = load_checkpoint(str(tmp_path / "ckpt_best.pt"))
        last = load_checkpoint(str(tmp_path / "ckpt_last.pt"))
        assert best["meta"] == last["meta"] == {"epoch": 0}
        for k, v in last["model"].items():
            assert torch.equal(v, best["model"][k]), k
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_non_finite_loss_aborts(roots, tmp_path):
    train_root, _ = roots
    pipe, _ = build_pipeline(1, 3, dtype=torch.float32, device="cpu", original_hw=(60, 100), min_size=64, max_size=128, cfg=TINY_CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "step", lambda self, batch: {"loss": torch.tensor(float("nan"))})
        with pytest.raises(FloatingPointError, match="Loss is nan"):
            train_unsupervised(pipe, train_root=train_root, output_dir=str(tmp_path), epochs=1)
