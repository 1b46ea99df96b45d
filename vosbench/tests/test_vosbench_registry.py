"""The benchmark finds every piece by name, and `BENCHMARK.json` keeps to
the contract's formats: a later cell, traffic mix, configuration or
per-layer metric is new files and new entries, and no edit."""
import json
import re
import shutil

import pytest

from vosbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vosbench"] and BENCH["command"] == ["python3", "vosbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_bounds():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names) and len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


def test_every_cell_reports_what_its_per_layer_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for cell in CELLS:
        spec = harness.cell_spec(cell)
        assert "setup_s" in spec["end_to_end"] and len(spec["end_to_end"]) >= 2 and spec["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    spec = harness.cell_spec(cell)
    assert spec["chips"] == 1
    assert (harness.BENCH / "drivers" / f"{spec['traffic']['driver']}.py").exists()
    assert (harness.BENCH / "generators" / f"{spec['traffic']['generator']}.py").exists()
    assert set(spec["limits"]) <= {"infer": {"mask_gap", "score_gap", "score_rel_gap", "box_gap"},
                                   "train": {"loss_gap", "grad_gap", "step_gap", "slowfast_grad_gap",
                                             "buffer_gap"}}[spec["traffic"]["driver"]]
    assert spec["limits"] and all(0 < v < 1 for v in spec["limits"].values())
    for metric in spec["per_layer"]:
        assert harness.reader(metric)({"counts": {}, "spans": {}}) is None  # finds nothing, reports nothing


def test_configs_state_their_source_and_cuts():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("vosbench/configs/")
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"] == []
        assert body["dtype"] == "bfloat16" and body["assumed"]


def test_a_new_cell_is_files_and_entries(tmp_path, monkeypatch):
    """A copy of the benchmark with one more traffic mix and one more cell,
    and no existing file of `vosbench/` edited, finds the new cell."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "vosbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sf3-3.infer.shortclips", "config": "sf3-3", "traffic": "shortclips",
                               "chips": 1, "why": "clips of 8-24 frames"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((harness.BENCH / "traffic" / "davis16val.json").read_text())
    traffic["lengths"] = [8, 16, 24] * 4
    (root / "vosbench" / "traffic" / "shortclips.json").write_text(json.dumps(traffic))
    limits = (harness.BENCH / "limits" / "sf3-3.infer.davis16val.json").read_text()
    (root / "vosbench" / "limits" / "sf3-3.infer.shortclips.json").write_text(limits)
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "vosbench")
    spec = harness.cell_spec("sf3-3.infer.shortclips")
    assert spec["traffic"]["lengths"][:3] == [8, 16, 24] and spec["config"]["slow"] == 3
    assert "infer_fps" not in spec["end_to_end"]  # the end-to-end entries list their cells
    with pytest.raises(KeyError):
        harness.cell_spec("sf3-3.infer.nowhere")
