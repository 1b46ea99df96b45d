"""The cell that came with ViTDet-B, `vitdet-b-sf3-3.infer.davis16val`,
through `harness.execute` at a tiny size on the CPU; the faults and the
float8 control that `correct` must catch; its traffic file against its
source; the two copies of the ViTDet reference; the yardstick's
arithmetic."""
import json
import sys

import pytest
import torch

from conftest import FAULT_SEED, SEED, TINY_CONFIG, TINY_TRAFFIC
from vosbench import harness, trace, weights_vitdet, yardstick_vitdet
from vosbench.reference import model as ref_model
from vosbench.reference import run as ref_run
from vosbench.reference import vitdet as ref_vitdet

VITDET_CELL = "vitdet-b-sf3-3.infer.davis16val"
TINY_VIT = {"embed": 64, "depth": 6, "heads": 2, "mlp": 128, "window": 3, "global_blocks": [2, 5],
            "pretrain_grid": 4, "image": 128}


def vitdet_overrides():
    return {"config": dict(TINY_CONFIG, min_size=128, max_size=128, square_pad=128, vit=TINY_VIT),
            "traffic": TINY_TRAFFIC["infer"]}


def run_vitdet(seed=SEED, trace_on=False):
    return harness.execute(VITDET_CELL, seed, 1.0, trace_on, device="cpu", overrides=vitdet_overrides())


def test_vitdet_cell_agrees_with_its_reference():
    r = run_vitdet()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"infer_fps", "setup_s"}
    assert r["checks"]["mask_gap"]["value"] == 0.0 and all(c["value"] < 1e-4 for c in r["checks"].values())
    launches = r["details"]["launches"]
    assert not any("attention" in k for k in launches)  # the plain version on the CPU: no K7 launch


def test_a_traced_vitdet_run_on_the_cpu_reports_only_host_metrics():
    r = run_vitdet(trace_on=True)
    assert set(r["metrics"]) == {"host_ms_per_frame.infer", "mfu.infer"} and r["correct"]


def _rel_w_dropped(original):
    def terms(q, rel_pos_h, rel_pos_w, hw):
        rel_h, rel_w = original(q, rel_pos_h, rel_pos_w, hw)
        return rel_h, rel_w * 0
    return terms


def _pos_dropped(original):
    def pos(pos_embed, hw, dtype):
        return original(pos_embed, hw, dtype) * 0
    return pos


def _bilinear(original):
    def pos(pos_embed, hw, dtype):
        grid = int((pos_embed.shape[1] - 1) ** 0.5)
        table = pos_embed[:, 1:].reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
        table = torch.nn.functional.interpolate(table, size=hw, mode="bilinear", align_corners=False)
        return table.permute(0, 2, 3, 1).to(dtype)
    return pos


@pytest.mark.parametrize("name,fault", [("rel_pos_terms", _rel_w_dropped), ("abs_pos", _pos_dropped),
                                        ("abs_pos", _bilinear)],
                         ids=["rel_w_dropped", "pos_embed_dropped", "bilinear_positions"])
def test_vitdet_faults_are_not_correct(monkeypatch, name, fault):
    from slowfast_vos_tpu_torch.models import vit

    monkeypatch.setattr(vit, name, fault(getattr(vit, name)))
    assert not run_vitdet(seed=FAULT_SEED)["correct"]


def _tiny_vitdet_cell(seed=SEED):
    from vosbench.drivers import infer_vitdet
    from vosbench.generators import blob_videos

    spec = harness.cell_spec(VITDET_CELL, vitdet_overrides())
    return spec, infer_vitdet.Cell(spec["config"], spec["traffic"], blob_videos, seed, "cpu", trace.Spans())


def test_vitdet_control_is_not_correct():
    from vosbench.calibrate import inference_control
    from vosbench.drivers import infer_vitdet

    spec, cell = _tiny_vitdet_cell(FAULT_SEED)
    cell.prepare()
    gaps, _ = inference_control(cell, cell.reference(fp8=True), cell.reference(), infer_vitdet.geometry(spec["config"]))
    assert any(v > spec["limits"][k] for k, v in gaps.items() if k in spec["limits"])


def test_the_two_vitdet_references_agree():
    """`vosbench/reference/vitdet.py` (the benchmark's frozen copy) and
    `tests/vitdet_reference.py` (the tier-1 tests') on the same weights."""
    sys.path.insert(0, str(harness.ROOT / "tests"))
    import vitdet_reference

    from vosbench.drivers import infer_vitdet

    spec, cell = _tiny_vitdet_cell()
    cell.prepare()
    cfg = spec["config"]
    det = ref_model.Detection(**cfg["detection"])
    widths = infer_vitdet.widths(cfg)
    ours = ref_vitdet.build(3, 3, det, cell.state, "cpu", widths=widths)
    theirs = vitdet_reference.build(3, 3, det, cell.state, "cpu", widths=vitdet_reference.Widths(**vars(widths)))
    geom = infer_vitdet.geometry(cfg)
    frames = torch.from_numpy(cell.sequences[0])
    a = ref_run.infer_sequence(ours, geom, frames)
    b = ref_run.infer_sequence(theirs, vitdet_reference.SquareGeometry(*vars(geom).values()), frames)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("new,source,changed", [("davis16val-vitdet", "davis16val", {"driver": "infer_vitdet"})])
def test_new_traffic_equals_its_source_but_for_its_driver(new, source, changed):
    load = lambda name: json.loads((harness.BENCH / "traffic" / f"{name}.json").read_text())  # noqa: E731
    got, want = load(new), load(source)
    assert {k: v for k, v in got.items() if k not in changed} == {k: v for k, v in want.items() if k != "driver"}
    assert {k: got[k] for k in changed} == changed


def test_vitdet_yardstick():
    cfg = harness.cell_spec(VITDET_CELL)["config"]
    v = cfg["vit"]
    ops, nbytes = yardstick_vitdet.attention_call(v, "global")
    assert ops == 12 * (4 * 4096**2 * 64 + 2 * 4096**2) and nbytes == 12 * (4 * 4096 * 64 + 2 * 4096 * 64) * 2
    ops, nbytes = yardstick_vitdet.attention_call(v, "window")
    assert ops == 25 * 12 * (4 * 196**2 * 64 + 2 * 196**2)
    # Global blocks are bound by the tensor cores, window blocks by memory.
    g, w = (yardstick_vitdet.attention_call(v, k) for k in ("global", "window"))
    assert g[0] / 989e12 > g[1] / 3.35e12 and w[0] / 989e12 < w[1] / 3.35e12
    assert 2.0e12 < yardstick_vitdet.infer_flops_per_frame(cfg) < 2.2e12
    assert [b[0] for b in yardstick_vitdet.blocks(v)].count("global") == 4
    assert yardstick_vitdet.blocks(v)[0][1] == 70 * 70  # window blocks' linears run on the padded grid


def test_weights_draw_the_position_terms():
    state = weights_vitdet.make_state(3, 3, TINY_CONFIG["detection"], SEED, "cpu",
                                      ref_vitdet.Widths(**dict(TINY_VIT, global_blocks=(2, 5))))
    assert abs(float(state["backbone.net.pos_embed"].std()) - weights_vitdet.POS) < 0.1
    assert abs(float(state["backbone.net.blocks.0.attn.rel_pos_w"].std()) - weights_vitdet.REL) < 0.03
    norms = state["backbone.net.blocks.0.norm1.weight"]
    assert float(norms.min()) >= 0.8 and float(norms.max()) <= 1.2
