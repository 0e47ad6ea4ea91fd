"""``run.py`` measures nothing without a card, and nothing without the
program; a small CPU run prints what the contract asks for."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.tests import tiny

ARGS = ["--workload", "omniscenes.query", "--seed", "2147483650",
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True, timeout=120,
                          env=env)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    res = _run(tiny.ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(tmp_path, env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_small_run_prints_the_contract(tmp_path):
    root = tiny.make(tmp_path)
    res = tiny.run(root, "omniscenes.query", 2147483650)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {"queries_per_s", "query_p90_s",
                                   "localized_pct", "setup_s"}
    assert res["checks"]["query_regret"]["limit"] == tiny.LIMITS[
        "query_regret"]
    json.dumps(res, allow_nan=False)
    traced = tiny.run(root, "omniscenes.track", 5, trace=True)
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert "track.batch_mean.track" in traced["metrics"]
