"""The port's data-parallel `train_unsupervised` on two `gloo` ranks (CPU,
f32, the tiny set-up: 60x100 frames, SlowFast 1-3, TINY_CFG): one epoch of
3 windows over 2 ranks, so the second group is wrap-filled with the
epoch's first window, with the sharded evaluation before and after.

The JAX `train_unsupervised` takes every global device, so the port's
driver is held against its own step-by-step replay: the same start
weights through `make_sharded_train_step` on the groups [w0, w1] and
[w2, w0], each rank taking its `local_batch_slice`, must give bit-identical
weights. Also: the history is identical on both ranks; only rank 0 writes
checkpoints and logs; the epoch loss is each group's mean loss times its
real windows, summed (2 * l0 + 1 * l1)."""
import json
import shutil

import pytest
import torch

from torch_parallel_common import TINY_HW, run_workers
from slowfast_vos_tpu_torch.data import make_synthetic_davis

WORKER = """
import glob, json
from torch_parallel_common import tiny_pipeline
from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence
from slowfast_vos_tpu_torch.data.windows import train_windows
from slowfast_vos_tpu_torch.models.pipeline import init_weights
from slowfast_vos_tpu_torch.parallel.distributed import local_batch_slice
from slowfast_vos_tpu_torch.parallel.sharded import make_sharded_train_step
from slowfast_vos_tpu_torch.train import Trainer
from slowfast_vos_tpu_torch.train.trainer import train_unsupervised

out_dir = os.path.join(WORK, f"out{RANK}")
pipe, model = tiny_pipeline()
trainer, history = train_unsupervised(
    pipe, train_root=os.path.join(WORK, "train17"), eval_root=os.path.join(WORK, "eval16"),
    output_dir=out_dir, epochs=1, max_windows_per_epoch=3, seed=0,
)
trained = {k: v.clone() for k, v in model.state_dict().items()}
logs = {}
for path in glob.glob(os.path.join(out_dir, "logs", "*.jsonl")):
    for rec in map(json.loads, open(path)):
        logs.setdefault(rec["tag"], []).append(rec["value"])

# Replay: the same start, the same groups, the same step.
init_weights(model, 0)
replay = Trainer(pipe, seed=0)
step = make_sharded_train_step(replay)
seq = load_sequence(DavisIndex(os.path.join(WORK, "train17"), "train", year="2017").sequences[0], max_gt=pipe.cfg.max_gt)
w = list(train_windows(seq, fast=pipe.sf.fast, n_center=replay.n_center))[:3]
for group in ([w[0], w[1]], [w[2], w[0]]):
    (batch,) = group[local_batch_slice(2)]
    step(batch)
same = all(torch.equal(v, trained[k]) for k, v in model.state_dict().items())
tree = sorted(os.listdir(os.path.join(out_dir, "results", "unsupervised", "slowfast_1-3")))
torch.save({"history": history, "files": sorted(os.listdir(out_dir)), "logs": logs, "replay_equal": same, "tree": tree},
           os.path.join(WORK, f"result{RANK}.pt"))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_train")
    make_synthetic_davis(str(work / "train17"), num_sequences=1, frames=6, hw=TINY_HW, num_objects=2)
    make_synthetic_davis(str(work / "eval16"), num_sequences=2, frames=4, hw=TINY_HW, num_objects=1, year="2016",
                         subset="val", seed=7)
    run_workers(WORKER, work, timeout=240)
    yield [torch.load(work / f"result{r}.pt", weights_only=False) for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)  # full-model checkpoints: none is kept after the module


def test_history_is_identical_on_both_ranks(results):
    """Everything but each rank's own evaluation wall time."""
    a, b = ([{**h, "eval": {k: v for k, v in h["eval"].items() if k != "wall"}} for h in r["history"]] for r in results)
    assert [h["epoch"] for h in a] == [0]
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert 0.0 <= a[0]["eval"]["jf"] <= 1.0


def test_only_rank_0_writes_checkpoints_and_logs(results):
    assert {"ckpt_last.pt", "ckpt_best.pt", "logs"} <= set(results[0]["files"])
    assert not {"ckpt_last.pt", "ckpt_best.pt"} & set(results[1]["files"])
    assert results[1]["logs"] == {}


def test_epoch_loss_sums_the_real_windows(results):
    logs = results[0]["logs"]
    l0, l1 = logs["train/batch_loss"]  # 2 groups: 3 windows over 2 ranks
    assert results[0]["history"][0]["loss"] == 0.0 + l0 * 2 + l1 * 1
    assert logs["train/epoch_loss"] == [results[0]["history"][0]["loss"]]


def test_driver_equals_its_step_replay_with_wrap_fill(results):
    assert results[0]["replay_equal"] and results[1]["replay_equal"]


def test_results_trees_hold_each_ranks_shard(results):
    """The sharded evaluation writes each rank's sequences (round-robin)."""
    assert [r["tree"] for r in results] == [["synth00"], ["synth01"]]
