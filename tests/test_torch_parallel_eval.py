"""Process-sharded evaluation, OSVOS and a CLI of the PyTorch port on two
`gloo` ranks (CPU, f32, the tiny set-up: 60x100 frames, SlowFast 1-3,
TINY_CFG, seeded weights), the JAX `tests/test_dp_eval_two_process.py`
claims held against the port's own serial paths:

* `extract_masks` and `davis_evaluation` split 3 sequences round-robin
  over the ranks; the shared PNG tree is byte-identical to the serial one,
  and the merged J/F table (`merge_scorer_metrics`) equals the serial
  scorer's on every rank;
* `merge_across_processes` (COCO shards) dedups a shared image id and keeps
  the gathered order, and scores as the single-process union does;
* `run_osvos_for_all_sequences` shards its fine-tunes, writes
  `<output_json>.rank<r>`, and its merged JSON equals a serial run's (but
  for each evaluation's wall time);
* `scripts/torch_evaluate.py` through `main(argv)` on both ranks gives the
  serial J&F."""
import json
import shutil

import pytest
import torch

from torch_parallel_common import TINY_HW, run_workers, tiny_pipeline
from slowfast_vos_tpu_torch.data import make_synthetic_davis
from slowfast_vos_tpu_torch.models.pipeline import init_weights
from slowfast_vos_tpu_torch.utils.checkpoint import save_checkpoint

WORKER = """
import numpy as np
from torch_parallel_common import tiny_build, tiny_pipeline
from scripts import torch_evaluate
from slowfast_vos_tpu_torch import cli
from slowfast_vos_tpu_torch.eval.coco import coco_map, merge_across_processes
from slowfast_vos_tpu_torch.eval.glue import davis_evaluation, extract_masks
from slowfast_vos_tpu_torch.eval.scorer import DavisScorer, summarize
from slowfast_vos_tpu_torch.models.pipeline import init_weights
from slowfast_vos_tpu_torch.parallel.distributed import host_barrier
from slowfast_vos_tpu_torch.train import osvos

root = os.path.join(WORK, "davis")
pipe, model = tiny_pipeline()
init_weights(model, 0)
out = {}

# Sharded evaluation into shared trees.
jf, summary, per_obj, _ = davis_evaluation(
    pipe, davis_root=root, results_root=os.path.join(WORK, "sharded_results"), model_name="m", year="2016",
)
out["summary"], out["per_obj"] = summary, per_obj
extract_masks(pipe, root, os.path.join(WORK, "sharded_tree"), year="2016")
if RANK == 0:
    extract_masks(pipe, root, os.path.join(WORK, "serial_tree"), year="2016", shard_by_process=False)
    metrics = DavisScorer(root, task="unsupervised", gt_set="val", year="2016").evaluate(
        os.path.join(WORK, "sharded_results", "unsupervised", "m"))
    out["serial_summary"] = summarize(metrics)
    out["serial_per_obj"] = {n: {"J-Mean": metrics["J"]["M_per_object"][n], "F-Mean": metrics["F"]["M_per_object"][n]}
                             for n in metrics["J"]["M_per_object"]}

# COCO shard merge (reference coco_eval.py:163-201): one own image and the
# shared image 100 on each rank.
def img(seed):
    r = np.random.default_rng(seed)
    boxes = np.sort(r.uniform(0, 50, (2, 2, 2)), axis=1).reshape(2, 4)
    return ({"boxes": boxes + r.uniform(0, 2, (2, 4)), "labels": np.ones(2, np.int64),
             "scores": r.uniform(0.5, 1.0, 2), "valid": np.ones(2, bool)},
            {"boxes": boxes, "labels": np.ones(2, np.int64), "valid": np.ones(2, bool)})
shared, own = img(100), img(RANK)
ids, preds, gts = merge_across_processes([100, RANK], [shared[0], own[0]], [shared[1], own[1]])
want_p, want_g = zip(*(img(i) for i in (100, 0, 1)))
out["coco_ids"] = ids
out["coco_map"] = (coco_map(preds, gts, kind="bbox")["mAP"], coco_map(list(want_p), list(want_g), kind="bbox")["mAP"])

# OSVOS over every sequence, sharded; rank 0 also serially.
start = {k: v.clone() for k, v in model.state_dict().items()}
kw = dict(davis_root=root, cfg=osvos.ExperimentConfig(freeze="BB_SF", epochs=1), items_per_epoch=2)
out["osvos"] = osvos.run_osvos_for_all_sequences(
    pipe, start, results_root=os.path.join(WORK, "osvos_res"), output_json=os.path.join(WORK, "osvos", "all.json"), **kw)
if RANK == 0:
    out["osvos_serial"] = osvos.run_osvos_for_all_sequences(
        pipe, start, results_root=os.path.join(WORK, "osvos_serial_res"),
        output_json=os.path.join(WORK, "osvos", "serial.json"), shard_by_process=False, **kw)
host_barrier("osvos_done")

# The evaluation CLI, sharded.
cli.build = tiny_build
ev = torch_evaluate.main([
    "--davis-root", root, "--checkpoint", os.path.join(WORK, "weights.pt"), "--results-root",
    os.path.join(WORK, "cli_results"), "--slow", "1", "--fast", "3", "--original-hw", "60", "100", "--device", "cpu",
])
out["cli_summary"] = ev["summary"]
torch.save(out, os.path.join(WORK, f"result{RANK}.pt"))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_eval")
    make_synthetic_davis(str(work / "davis"), num_sequences=3, frames=4, hw=TINY_HW, num_objects=1, year="2016",
                         subset="val", seed=11)
    (work / "osvos").mkdir()
    _, model = tiny_pipeline()
    init_weights(model, 0)
    save_checkpoint(str(work / "weights.pt"), model)
    run_workers(WORKER, work, timeout=300)
    yield work, [torch.load(work / f"result{r}.pt", weights_only=False) for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)  # a full-model checkpoint: none is kept after the module


def test_sharded_tree_is_byte_identical_to_serial(run):
    work, _ = run
    serial, sharded = work / "serial_tree", work / "sharded_tree"
    seqs = sorted(p.name for p in serial.iterdir())
    assert seqs == ["synth00", "synth01", "synth02"]
    assert sorted(p.name for p in sharded.iterdir()) == seqs
    for seq in seqs:
        files = sorted(p.name for p in (serial / seq).iterdir())
        assert sorted(p.name for p in (sharded / seq).iterdir()) == files and len(files) == 4
        for fn in files:
            assert (serial / seq / fn).read_bytes() == (sharded / seq / fn).read_bytes(), (seq, fn)


def test_merged_scores_equal_the_serial_scorer_on_every_rank(run):
    _, (r0, r1) = run
    assert r0["summary"] == r1["summary"] == r0["serial_summary"]
    assert r0["per_obj"] == r1["per_obj"] == r0["serial_per_obj"]
    assert list(r0["per_obj"]) == ["synth00_1", "synth01_1", "synth02_1"]  # global sequence order


def test_merge_across_processes_dedups_and_keeps_order(run):
    _, results = run
    for r in results:
        assert r["coco_ids"] == [100, 0, 1]
        got, want = r["coco_map"]
        assert abs(got - want) < 1e-12


def test_sharded_osvos_json_equals_serial(run):
    work, (r0, r1) = run
    strip = lambda res: {s: {e: {k: v for k, v in r.items() if k != "eval_time"} for e, r in per.items()}  # noqa: E731
                         for s, per in res.items()}
    assert list(r0["osvos"]) == list(r1["osvos"]) == ["synth00", "synth01", "synth02"]
    assert strip(r0["osvos"]) == strip(r1["osvos"]) == strip(r0["osvos_serial"])
    merged = json.loads((work / "osvos" / "all.json").read_text())
    serial = json.loads((work / "osvos" / "serial.json").read_text())
    assert strip(merged) == strip(serial) and list(merged["synth00"]) == ["-1", "0"]
    assert list(json.loads((work / "osvos" / "all.json.rank0").read_text())) == ["synth00", "synth02"]
    assert list(json.loads((work / "osvos" / "all.json.rank1").read_text())) == ["synth01"]


def test_evaluate_cli_sharded_equals_serial(run):
    _, (r0, r1) = run
    assert r0["cli_summary"] == r1["cli_summary"] == r0["serial_summary"]
