"""The PyTorch port's OSVOS drivers against the JAX package's, on a tiny
2016 val tree (2 sequences of 5 frames, 60x100, SlowFast 1-3, f32 on the
CPU) with the same weights: `train_osvos_sequence` under the default
freeze `SF` (backbone and heads train, SlowFast frozen), the full-val run
with its incremental JSON, the grid sweep with resume-by-skipping, and the
per-epoch summary.

The results carry the JAX driver's epochs (-1 for the sanity evaluation,
then 0..epochs-1) and keys; every fine-tune starts from the weights it is
given, whatever the previous one trained; the SlowFast weights stay
bit-identical under `SF`."""
import json
import os

import pytest
import torch

from torch_port_common import TINY_HW, tiny_pipelines
from slowfast_vos_tpu.data.synthetic import make_synthetic_davis
from slowfast_vos_tpu.train.osvos import ExperimentConfig as JaxExperimentConfig
from slowfast_vos_tpu.train.osvos import summarize_osvos_results as jax_summarize
from slowfast_vos_tpu.train.osvos import train_osvos_sequence as jax_train_osvos_sequence
from slowfast_vos_tpu_torch.train.osvos import (
    ExperimentConfig,
    _freeze_flags,
    run_osvos_experiments,
    run_osvos_for_all_sequences,
    summarize_osvos_results,
    train_osvos_sequence,
)

ITEMS = 2  # one optimizer step per epoch (accumulate 2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("d16"))
    make_synthetic_davis(root, num_sequences=2, frames=5, hw=TINY_HW, num_objects=1, year="2016", subset="val")
    jpipe, variables, pipe, state_dict = tiny_pipelines(slow=1, fast=3, seed=2)
    jax_results = jax_train_osvos_sequence(
        jpipe, variables, davis_root=root, sequence_name="synth00",
        results_root=str(tmp_path_factory.mktemp("jax_res")),
        cfg=JaxExperimentConfig(freeze="SF", epochs=1), items_per_epoch=ITEMS,
    )
    return {"root": root, "pipe": pipe, "state_dict": state_dict, "jax_results": jax_results}


def layout(results: dict) -> dict:
    """{epoch: sorted keys} of one sequence's results."""
    return {int(e): sorted(r) for e, r in results.items()}


def test_freeze_flags_match_jax():
    from slowfast_vos_tpu.train.osvos import _freeze_flags as jax_freeze_flags

    for freeze in ("none", "SF", "BB_SF"):
        assert _freeze_flags(freeze) == jax_freeze_flags(freeze)
    assert str(ExperimentConfig()) == str(JaxExperimentConfig()) == "Freeze: SF Lr: 0.001 Scale: 0.25"


def test_sequence_results_match_jax_layout_and_sf_freeze(setup, tmp_path):
    pipe, start = setup["pipe"], setup["state_dict"]
    results = train_osvos_sequence(
        pipe, start, davis_root=setup["root"], sequence_name="synth00", results_root=str(tmp_path),
        cfg=ExperimentConfig(freeze="SF", epochs=1), items_per_epoch=ITEMS,
    )
    assert layout(results) == layout(setup["jax_results"]) == {-1: ["eval_time", "fmean", "jfmean", "jmean"], 0: ["eval_time", "fmean", "jfmean", "jmean"]}
    for r in results.values():
        assert 0.0 <= r["jfmean"] <= 1.0 and r["eval_time"] > 0
        assert abs(r["jfmean"] - (r["jmean"] + r["fmean"]) / 2) < 1e-12
    res_dir = tmp_path / "semi-supervised" / "osvos_1-3_synth00" / "synth00"
    assert sorted(os.listdir(res_dir)) == [f"{i:05d}.png" for i in range(5)]

    # SF: the SlowFast weights and every FrozenBatchNorm buffer are
    # bit-identical; the backbone, RPN and head weights moved; the SlowFast
    # running statistics moved too (its BatchNorms run in train mode under
    # every freeze, as in the JAX step).
    params = dict(pipe.model.named_parameters())
    after = pipe.model.state_dict()
    for k, v in start.items():
        if k in params and k.startswith("slow_fast.") or k not in params and not k.startswith("slow_fast."):
            assert torch.equal(after[k], v), k
        elif k in params and v.dim() > 1:
            assert not torch.equal(after[k], v), k
        elif "running" in k:
            assert not torch.equal(after[k], v), k


def test_all_sequences_start_from_the_given_weights(setup, tmp_path):
    """Two sequences, each from the same weights (given as the live state
    dict, which training in place must not alias): the second's sanity
    evaluation equals that of a fresh run from the weights, and the
    incremental JSON holds both sequences in the JAX results layout."""
    pipe = setup["pipe"]
    pipe.model.load_state_dict(setup["state_dict"])
    out_json = str(tmp_path / "all.json")
    cfg = ExperimentConfig(freeze="BB_SF", epochs=1)
    results = run_osvos_for_all_sequences(
        pipe, pipe.model.state_dict(), davis_root=setup["root"], results_root=str(tmp_path / "res"),
        output_json=out_json, cfg=cfg, items_per_epoch=ITEMS,
    )
    assert list(results) == ["synth00", "synth01"]
    on_disk = json.load(open(out_json))
    assert {s: layout(r) for s, r in on_disk.items()} == {s: layout(setup["jax_results"]) for s in results}
    fresh = train_osvos_sequence(
        pipe, setup["state_dict"], davis_root=setup["root"], sequence_name="synth01",
        results_root=str(tmp_path / "fresh"), cfg=ExperimentConfig(epochs=0),
    )
    assert list(fresh) == [-1]
    assert fresh[-1]["jfmean"] == results["synth01"][-1]["jfmean"]
    assert summarize_osvos_results(out_json, epochs=1) == jax_summarize(out_json, epochs=1)
    rows = summarize_osvos_results(out_json, epochs=3)
    assert [r["epoch"] for r in rows] == [0] and sorted(rows[0]) == ["epoch", "f", "j", "jf", "time"]


def test_experiment_sweep_resumes_by_skipping(setup, tmp_path):
    pipe = setup["pipe"]
    exp_dir = tmp_path / "experiments"
    kw = dict(
        davis_root=setup["root"], results_root=str(tmp_path / "res"), experiments_dir=str(exp_dir),
        freeze_options=("BB_SF",), scales=(0.25,), lrs=(1e-3,), sequences=("synth00",),
        epochs=1, items_per_epoch=ITEMS,
    )
    run_osvos_experiments(pipe, setup["state_dict"], **kw)
    files = sorted(os.listdir(exp_dir))
    assert files == ["osvos_sp_1fp_3_freeze_BB_SF_scale_0.25_lr_0.001.json"]
    results = json.load(open(exp_dir / files[0]))
    assert {s: layout(r) for s, r in results.items()} == {"synth00": layout(setup["jax_results"])}
    # resume-by-skip: a finished config's file survives a second run untouched
    marker = exp_dir / files[0]
    marker.write_text('{"sentinel": true}')
    run_osvos_experiments(pipe, setup["state_dict"], **kw)
    assert json.loads(marker.read_text()) == {"sentinel": True}
    assert sorted(os.listdir(exp_dir)) == files


def test_summary_of_one_json_matches_jax(tmp_path):
    path = str(tmp_path / "r.json")
    rows = {"a": {"-1": 0.1, "0": 0.5, "1": 0.25}, "b": {"-1": 0.2, "0": 0.75}}
    data = {s: {e: {"jfmean": v, "jmean": v / 2, "fmean": v * 1.5, "eval_time": 3 * v} for e, v in r.items()} for s, r in rows.items()}
    json.dump(data, open(path, "w"))
    for epochs in (1, 2, 5):
        assert summarize_osvos_results(path, epochs) == jax_summarize(path, epochs)
    assert [r["epoch"] for r in summarize_osvos_results(path, 5)] == [0, 1]
