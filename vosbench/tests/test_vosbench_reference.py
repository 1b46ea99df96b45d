"""The reference against the port at a tiny size on the CPU, where both run
float32 and agree to rounding; the run with the timed path broken
underneath, once for each fault the cells can have, which `correct` has to
catch; and the control, the reference in float8 in the program's place,
which it has to catch too. The card's readings that set the limits are in
PERF.md."""
import importlib

import pytest
import torch

from conftest import FAULT_SEED, INFER_CELL, SEED, TRAIN_CELL, tiny
from vosbench import compare, harness, trace


def test_port_and_reference_agree_in_inference(run_tiny):
    r = run_tiny(INFER_CELL)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"infer_fps", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["mask_gap"]["value"] == 0.0
    assert all(c["value"] < 1e-4 for c in r["checks"].values())
    assert r["details"]["box_gap"] < 1e-4


def test_port_and_reference_agree_in_training(run_tiny):
    r = run_tiny(TRAIN_CELL)
    assert r["correct"] and r["failed"] == 0
    assert set(r["metrics"]) == {"train_step_ms", "train_step_p95_ms", "setup_s"}
    assert all(c["value"] < 1e-3 for c in r["checks"].values())  # float32 on both sides, sums in other orders
    assert sorted(r["details"]["left_out"]) == [f"slow_fast.{p}_conv{i}.bias" for p in ("fast", "slow") for i in (1, 2, 3)]


def test_a_traced_run_on_the_cpu_reports_only_host_metrics(run_tiny):
    r = run_tiny(INFER_CELL, trace=True)
    # No device trace on the CPU: the device readers find nothing and stay silent.
    assert set(r["metrics"]) == {"host_ms_per_frame.infer", "mfu.infer"}
    assert r["correct"] and "breakdown" not in r


def _finalize_shifted(original):
    def finalize(self, *detections):
        boxes, *rest = original(self, *detections)
        return (boxes + 16.0, *rest)
    return finalize


def _finalize_scored(original):
    def finalize(self, *detections):
        boxes, scores, *rest = original(self, *detections)
        return (boxes, scores * 0.8, *rest)
    return finalize


def _superchunk_half(original):
    def superchunk(self, images, feat_valid, carry=None, instance_masks=False):
        outs, next_carry = original(self, images, feat_valid, carry, instance_masks)
        half = outs[0].shape[0] // 2
        return tuple(torch.cat([o[:half], o[:half], o[2 * half:]]) for o in outs), next_carry
    return superchunk


def _shift_dropped(original):
    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * inv.to(x.dtype)[:, None, None]
    return forward


def _frozen_bn_class():
    from slowfast_vos_tpu_torch.models.layers import FrozenBatchNorm2d

    return FrozenBatchNorm2d


def _pipeline_class():
    from slowfast_vos_tpu_torch.models.pipeline import Pipeline

    return Pipeline


@pytest.mark.parametrize("cell", [INFER_CELL, "sf7-7.infer.davis16val"])
@pytest.mark.parametrize("owner,method,fault", [
    (_pipeline_class, "_finalize", _finalize_shifted), (_pipeline_class, "_finalize", _finalize_scored),
    (_pipeline_class, "_superchunk", _superchunk_half), (_frozen_bn_class, "forward", _shift_dropped)],
    ids=["boxes_altered", "scores_altered", "half_the_frames_left_out", "frozen_bn_shift_dropped"])
def test_inference_faults_are_not_correct(run_tiny, monkeypatch, cell, owner, method, fault):
    cls = owner()
    monkeypatch.setattr(cls, method, fault(getattr(cls, method)))
    assert not run_tiny(cell, seed=FAULT_SEED)["correct"]


def _update_skipped(original):
    def device_update(self):
        self.optimizer.zero_grad(set_to_none=False)
    return device_update


def _half_batch(original):
    def loss(self, batch, draws):
        batch = dict(batch)
        keep = torch.arange(batch["frame_valid"].shape[0]) < batch["frame_valid"].shape[0] // 2
        batch["frame_valid"] = torch.as_tensor(batch["frame_valid"]) & keep
        total, metrics = original(self, batch, draws)
        return 2 * total, metrics
    return loss


def _loss_altered(original):
    def step(self, batch, draws=None):
        metrics = original(self, batch, draws)
        return dict(metrics, loss=metrics["loss"] * 1.25)
    return step


def _statistics_kept(original):
    def plain(x, bn, momentum=0.9, relu=False):
        before = bn.running_mean.clone(), bn.running_var.clone()
        out = original(x, bn, momentum, relu)
        with torch.no_grad():
            bn.running_mean.copy_(before[0])
            bn.running_var.copy_(before[1])
        return out
    return plain


def _trainer_class():
    from slowfast_vos_tpu_torch.train.train_step import Trainer

    return Trainer


def _slowfast_module():
    from slowfast_vos_tpu_torch.models import slowfast

    return slowfast


@pytest.mark.parametrize("cell", [TRAIN_CELL, "sf7-7.train.davis17"])
@pytest.mark.parametrize("owner,method,fault", [
    (_trainer_class, "device_update", _update_skipped), (_trainer_class, "loss", _half_batch),
    (_trainer_class, "step", _loss_altered), (_slowfast_module, "batch_norm_train_plain", _statistics_kept)],
    ids=["state_unchanged", "half_the_batch_left_out", "loss_altered", "running_statistics_unchanged"])
def test_training_faults_are_not_correct(run_tiny, monkeypatch, cell, owner, method, fault):
    target = owner()
    monkeypatch.setattr(target, method, fault(getattr(target, method)))
    assert not run_tiny(cell, seed=FAULT_SEED)["correct"]


def _tiny_cell(cell):
    spec = harness.cell_spec(cell, tiny("infer" if "infer" in cell else "train"))
    traffic = spec["traffic"]
    driver = importlib.import_module(f"vosbench.drivers.{traffic['driver']}")
    generator = importlib.import_module(f"vosbench.generators.{traffic['generator']}")
    return spec, driver.Cell(spec["config"], traffic, generator, SEED, "cpu", trace.Spans())


def _fails(gaps, limits):
    return any(v > limits[k] for k, v in gaps.items() if k in limits)


def test_control_is_not_correct_in_inference():
    from vosbench.calibrate import inference_control
    from vosbench.reference import model as ref_model
    from vosbench.reference import run as ref_run

    spec, cell = _tiny_cell(INFER_CELL)
    cfg = spec["config"]
    cell.prepare()
    det = ref_model.Detection(**cfg["detection"])
    fp8 = ref_run.build(cfg["slow"], cfg["fast"], det, cell.state, "cpu", fp8=True)
    f32 = ref_run.build(cfg["slow"], cfg["fast"], det, cell.state, "cpu")
    geom = ref_model.Geometry(tuple(cfg["original_hw"]), cfg["min_size"], cfg["max_size"])
    gaps, _ = inference_control(cell, fp8, f32, geom)
    assert _fails(gaps, spec["limits"])


def test_control_is_not_correct_in_training():
    spec, cell = _tiny_cell(TRAIN_CELL)
    try:
        cell.prepare()
        gaps, _ = compare.training_gaps(cell.reference_steps(fp8=True), cell.reference_steps())
    finally:
        cell.close()
    assert _fails(gaps, spec["limits"])
