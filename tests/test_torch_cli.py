"""The PyTorch port's command-line entry points (`scripts/torch_*.py`),
driven in-process through `main(argv)` on the CPU at the tiny set-up (60x100
frames, min 64 / max 128, SlowFast 1-3, TINY_CFG, f32; the CLIs' pipeline
factory `cli.build` is patched to it) on synthetic DAVIS trees.

The reference's chain: the Mask R-CNN fine-tune and its proposal dump,
unsupervised training started from that checkpoint (its `slow_fast.*` left at
the seeded init and reported untouched), evaluation of the best checkpoint,
extraction of the results tree and the standalone scorer on it (the same
J&F as the evaluation), the overlay dump, an OSVOS fine-tune of 2 items (one update), and the
OSVOS run over every sequence.
Also: the CLIs run on the card unless asked for the CPU and raise without
one, refuse a multi-process launch, and the benchmark exits non-zero
without CUDA."""
import functools
import json
import os

import numpy as np
import pytest
import torch

from torch_port_common import TINY_CFG, TINY_HW
from scripts import (
    torch_bench,
    torch_evaluate,
    torch_extract_for_davis_eval,
    torch_predict,
    torch_pretrain_maskrcnn,
    torch_score,
    torch_train,
    torch_train_osvos,
)
from slowfast_vos_tpu_torch import cli
from slowfast_vos_tpu_torch.data import make_synthetic_davis
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline
from slowfast_vos_tpu_torch.train import osvos

MODEL = ["--slow", "1", "--fast", "3", "--original-hw", str(TINY_HW[0]), str(TINY_HW[1])]
CPU = ["--device", "cpu"]


def tiny_build(slow, fast, original_hw, *, device, dtype=None, use_slow_fast=True):
    """`cli.build` at the tiny set-up, in f32, superchunk 4; the device as
    asked."""
    assert tuple(original_hw) == TINY_HW
    return build_pipeline(
        slow, fast, TINY_HW, min_size=64, max_size=128, cfg=TINY_CFG, dtype=torch.float32,
        device=device, use_slow_fast=use_slow_fast, superchunk=4,
    )


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The whole chain, once; each test reads its part."""
    work = tmp_path_factory.mktemp("cli")
    train_root, eval_root = str(work / "train17"), str(work / "eval16")
    make_synthetic_davis(train_root, num_sequences=1, frames=4, hw=TINY_HW, num_objects=2)
    make_synthetic_davis(eval_root, num_sequences=1, frames=4, hw=TINY_HW, num_objects=1, year="2016", subset="val", seed=7)
    out = {"work": work, "eval_root": eval_root}
    pre, run = str(work / "pre"), str(work / "un")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "build", tiny_build)
        mp.setattr(osvos, "train_osvos_sequence", functools.partial(osvos.train_osvos_sequence, items_per_epoch=2))
        hw = ["--original-hw", str(TINY_HW[0]), str(TINY_HW[1])]
        out["pretrain"] = torch_pretrain_maskrcnn.main(["--davis-root", train_root, "--output", pre, "--epochs", "1", *hw, *CPU])
        ckpt = os.path.join(pre, "maskrcnn_model.pt")
        out["boxes"] = torch_pretrain_maskrcnn.main(
            ["--davis-root", train_root, "--output", pre, "--predict-boxes", "--init-checkpoint", ckpt, *hw, *CPU]
        )
        out["train"] = torch_train.main(
            ["--train-root", train_root, "--eval-root", eval_root, "--output", run, "--epochs", "1",
             "--init-checkpoint", ckpt, "--no-data-parallel", *MODEL, *CPU]
        )
        best = os.path.join(run, "ckpt_best.pt")
        common = ["--davis-root", eval_root, "--checkpoint", best, *MODEL, *CPU]
        out["evaluate"] = torch_evaluate.main([*common, "--results-root", str(work / "res")])
        out["extract"] = torch_extract_for_davis_eval.main([*common, "--out-dir", str(work / "extract")])
        score = ["--davis-root", eval_root, "--results-path", str(work / "extract")]
        out["score"] = torch_score.main([*score, "--codalab"])
        out["score_cached"] = torch_score.main(score)
        out["predict"] = torch_predict.main([*common, "--out-dir", str(work / "pred"), "--save-all"])
        out["osvos"] = torch_train_osvos.main(
            [*common, "--sequence", "synth00", "--epochs", "1", "--results-root", str(work / "osvos")]
        )
        out["osvos_all"] = torch_train_osvos.main(
            [*common, "--mode", "all", "--epochs", "0", "--results-root", str(work / "osvos"),
             "--output-json", str(work / "osvos_all" / "all.json")]
        )
    return out


def test_pretrain_then_proposals(chain):
    (h,) = chain["pretrain"]["history"]
    assert h["epoch"] == 0 and np.isfinite(h["loss"]) and chain["pretrain"]["load"] is None
    report = chain["boxes"]["load"]
    assert report["unused_source_keys"] == [] and report["untouched"] == []
    npz = np.load(chain["boxes"]["proposals"])
    assert npz["synth00/proposals"].shape == (4, TINY_CFG.rpn_post_nms_top_n_test, 4)


def test_train_starts_from_the_maskrcnn_checkpoint(chain):
    """F2: every tensor of the Mask R-CNN checkpoint lands; `slow_fast.*`
    stays at the seeded init and is reported untouched."""
    report = chain["train"]["load"]
    model = tiny_build(1, 3, TINY_HW, device="cpu")[1]
    sf = [k for k in model.state_dict() if k.startswith("slow_fast.") and "num_batches_tracked" not in k]
    assert report["unused_source_keys"] == [] and report["untouched"] == sf
    assert report["converted"] == len([k for k in model.state_dict() if not k.startswith("slow_fast.")])
    (h,) = chain["train"]["history"]
    assert h["epoch"] == 0 and np.isfinite(h["loss"]) and 0.0 <= h["eval"]["jf"] <= 1.0


def test_score_of_the_extracted_tree_equals_evaluate(chain):
    ev, summary = chain["evaluate"], chain["score"]
    assert ev["load"]["unused_source_keys"] == [] and ev["load"]["untouched"] == []
    assert summary.keys() == ev["summary"].keys()
    for k, v in summary.items():
        assert abs(v - ev["summary"][k]) <= 1e-6, (k, v, ev["summary"][k])
    extract = chain["work"] / "extract"
    assert sorted(os.listdir(extract / "synth00")) == [f"{i:05d}.png" for i in range(4)]
    scores = (extract / "scores.txt").read_text().splitlines()
    assert scores[0].startswith("JANDF_Mean: ")
    assert chain["score_cached"] is None  # the CSV cache answers the second call


def test_predict_writes_every_overlay(chain):
    assert 0.0 <= chain["predict"]["miou"] <= 1.0
    names = sorted(os.listdir(chain["work"] / "pred"))
    assert len(names) == 4 and all(n.startswith(f"synth00_{i:05d}_iou") for i, n in enumerate(names))


def test_osvos_single_and_all(chain):
    results = chain["osvos"]
    assert sorted(results) == [-1, 0]
    assert all(sorted(r) == ["eval_time", "fmean", "jfmean", "jmean"] for r in results.values())
    # --mode all, no epochs: every sequence's sanity evaluation, dumped as JSON.
    dumped = json.loads((chain["work"] / "osvos_all" / "all.json").read_text())
    assert list(dumped) == list(chain["osvos_all"]) == ["synth00"] and list(dumped["synth00"]) == ["-1"]


def test_entry_points_need_the_card_unless_asked(tmp_path, monkeypatch):
    """No CPU fallback: without `--device cpu` a CLI raises here, before it
    builds a model."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_evaluate.main(["--davis-root", str(tmp_path), "--checkpoint", str(tmp_path / "none.pt")])


@pytest.mark.parametrize("var", ["WORLD_SIZE", "SLURM_NTASKS"])
def test_multi_process_launch_raises(var, tmp_path, monkeypatch):
    monkeypatch.setenv(var, "2")
    with pytest.raises(RuntimeError, match="no parallel layer"):
        torch_train.main(["--train-root", str(tmp_path), *CPU])


def test_bench_exits_non_zero_without_cuda(monkeypatch, capsys):
    """The benchmark never measures the CPU: it exits with a message and
    prints no record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available") as exc:
        torch_bench.main(["--runs", "1"])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""
