"""One run of one cell: find its pieces by name, set up, measure, check.

`execute` does everything a run does except the look for a card, so that
the tests can drive it on the CPU at a tiny size (`overrides`). The cell's
configuration and traffic names, and which metrics it reports, come from
`BENCHMARK.json`; everything else from the files named there:

* `configs/<config>.json`: the model and how the program runs it;
* `traffic/<traffic>.json`: the mix, which names its `generator`
  (`generators/<name>.py`) and its `driver` (`drivers/<name>.py`);
* `metrics/<metric>.py`: each per-layer metric's reader, `read(record)`,
  which returns a number or None when it finds nothing to read;
* `limits/<cell>.json`: the limit of each number that decides `correct`;
  a number that the driver computes and the file leaves out is only
  recorded in the run's details.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_SECONDS = 6.0  # the traced segment ahead of the window: its units of work that start in its first 6 s


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def canvas_hw(config: dict) -> tuple[int, int]:
    from vosbench.reference.model import Geometry

    return Geometry(tuple(config["original_hw"]), config["min_size"], config["max_size"]).canvas_hw


def cell_spec(name: str, overrides: dict | None = None) -> dict:
    """Everything a run of cell `name` needs, from `BENCHMARK.json` and the
    files it names; `overrides` (tests only) replace parts of the config,
    the traffic and the limits."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    overrides = overrides or {}
    config = merged(load_json(BENCH / "configs" / f"{cell['config']}.json"), overrides.get("config"))
    config["canvas_hw"] = canvas_hw(config)
    config["detection"]["bbox_reg_weights"] = tuple(config["detection"]["bbox_reg_weights"])
    traffic = merged(load_json(BENCH / "traffic" / f"{cell['traffic']}.json"), overrides.get("traffic"))

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "name": name, "chips": cell["chips"], "config": config, "traffic": traffic,
        "end_to_end": [m["name"] for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m["name"] for m in bench["per_layer"] if applies(m)],
        "limits": merged(load_json(BENCH / "limits" / f"{name}.json"), overrides.get("limits")),
    }


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"vosbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def execute(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", t0: float | None = None,
            overrides: dict | None = None) -> dict:
    """One run: set-up, the window, the check. Returns the result object
    (without the look for a card, and without printing)."""
    import torch

    from vosbench import trace as trace_mod

    t0 = time.perf_counter() if t0 is None else t0
    spec = cell_spec(name, overrides)
    traffic = spec["traffic"]
    driver = importlib.import_module(f"vosbench.drivers.{traffic['driver']}")
    generator = importlib.import_module(f"vosbench.generators.{traffic['generator']}")
    spans = trace_mod.Spans()
    cell = driver.Cell(spec["config"], traffic, generator, seed, device, spans)
    dev = torch.device(device)
    try:
        cell.setup()
        setup_s = time.perf_counter() - t0
        profile = trace_mod.DeviceTrace(spans) if trace and dev.type == "cuda" else None
        run = cell.window(seconds, profile, TRACE_SECONDS)
        info = device_info(dev)
        record = None
        if trace:
            record = {"config": spec["config"], "traffic": traffic, "counts": run["counts"], "traced": run["traced"],
                      "spans": dict(spans.total), "flops": driver.flops(spec["config"], traffic, run["counts"])}
            record["device"] = profile.reduce() if profile is not None else None
        cell.release()
        gaps, details = cell.check()
    finally:
        close = getattr(cell, "close", None)
        if close is not None:
            close()
    values = dict(run["e2e"], setup_s=setup_s)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(m)(record)
            if v is not None:
                metrics[m] = v
    else:
        metrics = {m: values[m] for m in spec["end_to_end"]}
    # A number the cell's limits file leaves out is recorded, not compared.
    details.update({k: v for k, v in gaps.items() if k not in spec["limits"]})
    checks = {k: {"value": float(gaps[k]), "limit": float(v)} for k, v in spec["limits"].items()}
    correct = run["failed"] == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in load_json(ROOT / "BENCHMARK.json")[("per_layer" if trace else "end_to_end")]}
    result = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"],
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()}, "device": info}
    if trace and record["device"] is not None:
        dv = record["device"]
        info["busy_s"] = dv["busy_s"]
        info["window_s"] = dv["window_s"]
        ops = sorted(dv["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, (s, _) in ops],
                               "idle_gaps": sorted(([k, v] for k, v in dv["idle"].items()), key=lambda kv: -kv[1])[:10]}
    result["details"] = details
    result["checks"] = checks
    return result
