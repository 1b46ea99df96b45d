"""The command as the driver runs it: no result without a card, none in a
checkout that holds only the benchmark, and (on the card) one result line
whose `correct` holds."""
import json
import shutil
import subprocess
import sys

import pytest

from conftest import INFER_CELL, SEED
from vosbench.harness import ROOT


def run(cwd, *extra, timeout=900):
    return subprocess.run([sys.executable, "vosbench/run.py", "--workload", INFER_CELL, "--seed", str(SEED),
                           "--seconds", "3", "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vosbench", tmp_path / "vosbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run(ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["metrics"]["infer_fps"]["value"] > 0
    assert list(line)[-1] == "checks"
