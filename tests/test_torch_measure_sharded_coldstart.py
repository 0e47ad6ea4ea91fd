"""The port's sharded-restart measurement script
(``scripts/measure_sharded_coldstart_cuda.py``) on the CPU: two fresh
processes on one executable-cache directory, at a small room.

  * the first finds the directory empty (``restart`` false) and builds
    its library (on the CPU, the JPEG codec alone) into it; the second
    finds it (``restart`` true) and loads it: ``loaded``, every library a
    hit, nothing built;
  * both answer the same query over the 1 x 1 mesh with the same
    ``t_err``;
  * the JSON keys are the JAX script's (``scripts/measure_sharded_
    coldstart.py``, read from its source: its phases' keys come from
    instrumenting its cache's load and store), the port adding ``hits``,
    ``built`` and the first query's graph captures.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "measure_sharded_coldstart_cuda.py"
SMALL = ["--points", "3000", "--height", "32", "--num-iter", "20"]


def _jax_keys() -> set:
    """Every key the JAX script writes into its JSON line: the dict it
    starts from, its ``out[...]`` assignments and its cache phases'
    (``load_s``, ``loaded``, ``bytes``; ``serialize_store_s`` only where
    it stores)."""
    tree = ast.parse((ROOT / "scripts" / "measure_sharded_coldstart.py")
                     .read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and isinstance(node.value, ast.Name) \
                and node.value.id in ("out", "phases"):
            keys.add(node.slice.value)
        if isinstance(node, ast.AnnAssign) and isinstance(node.value,
                                                          ast.Dict):
            keys |= {k.value for k in node.value.keys}
    return keys - {"serialize_store_s"}


def _run(cache_dir, tmp):
    proc = subprocess.run(
        [sys.executable, str(SCRIPT), "--exec-cache", str(cache_dir),
         "--device", "cpu"] + SMALL,
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, TMPDIR=str(tmp), OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_restart_loads_every_library(tmp_path):
    cache_dir = tmp_path / "exec"
    first = _run(cache_dir, tmp_path)
    second = _run(cache_dir, tmp_path)
    assert first["restart"] is False and second["restart"] is True
    assert first["built"] and not first["hits"] and first["loaded"] is False
    assert second["hits"] == first["built"] and not second["built"]
    assert second["loaded"] is True
    assert second["bytes"] == first["bytes"] > 0
    assert first["t_err_m"] == second["t_err_m"]
    assert first["mesh"] == second["mesh"] == {"cand": 1, "point": 1}
    keys = _jax_keys()
    assert keys == {"mode", "device", "n_devices", "restart",
                    "fetch_init_s", "mesh", "first_query_s", "t_err_m",
                    "load_s", "loaded", "bytes", "steady_s"}
    assert set(second) == keys | {"hits", "built", "graph_captures",
                                  "graph_capture_s"}
    assert second["device"] == "cpu" and second["graph_captures"] == 0
