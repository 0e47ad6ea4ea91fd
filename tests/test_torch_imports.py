"""piccolo_tpu_torch stands alone: it imports no JAX, nothing of
piccolo_tpu, neither cv2 nor PIL, and no matplotlib at import (the card
machine has no cv2 or matplotlib), and its entry points refuse to run on
the CPU unless asked."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import piccolo_tpu_torch
from piccolo_tpu_torch import (
    build_grid_plan,
    build_hist_plan,
    demo,
    eval_synth,
    localize_query,
)
from piccolo_tpu_torch.serve import LocalizeService
from piccolo_tpu_torch.tracking import track_step, track_step_prepped_fetched

PKG = pathlib.Path(piccolo_tpu_torch.__file__).resolve().parent

_PROBE = """
import importlib, pkgutil, sys
import piccolo_tpu_torch
for m in pkgutil.walk_packages(piccolo_tpu_torch.__path__, "piccolo_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "piccolo_tpu", "cv2",
                                    "PIL", "matplotlib"))
print(len([k for k in sys.modules if k.startswith("piccolo_tpu_torch.")]))
print(bad)
"""


def test_import_loads_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], check=True,
                         capture_output=True, text=True,
                         cwd=PKG.parent).stdout.split("\n")
    # every submodule, tracking, serve, parallel, and since the profiling
    # and executable-cache slice utils (profiling, exec_cache, debug),
    # ops.warp and harness.gif
    assert int(out[0]) >= 49
    assert out[1] == "[]"


def test_parallel_imports_alone_without_jax():
    """``piccolo_tpu_torch.parallel`` on its own pulls in no JAX and
    nothing of the JAX package."""
    probe = ("import sys, piccolo_tpu_torch.parallel as p; "
             "print(sorted(k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'piccolo_tpu'))); print(p.make_mesh.__module__)")
    out = subprocess.run([sys.executable, "-c", probe], check=True,
                         capture_output=True, text=True,
                         cwd=PKG.parent).stdout.split("\n")
    assert out[:2] == ["[]", "piccolo_tpu_torch.parallel.sharding"]


@pytest.mark.parametrize("module", ["eval_synth", "synth_dataset", "demo"])
def test_tools_import_alone_without_jax(module):
    """The evaluation, the dataset generator and the demo, each on its own,
    pull in no JAX and nothing of the JAX package."""
    probe = (f"import sys, piccolo_tpu_torch.{module} as m; "
             "print(sorted(k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'piccolo_tpu'))); print(callable(m.main))")
    out = subprocess.run([sys.executable, "-c", probe], check=True,
                         capture_output=True, text=True,
                         cwd=PKG.parent).stdout.split("\n")
    assert out[:2] == ["[]", "True"]


MEASURE_SCRIPTS = ("measure_tracking_cuda", "measure_serving_cuda",
           "measure_plan_lifecycle_cuda", "measure_sharded_coldstart_cuda",
           "bench_descent_step")

_SCRIPT_PROBE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("script", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
print(sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "piccolo_tpu", "cv2")))
print(callable(m.main))
"""


@pytest.mark.parametrize("script", MEASURE_SCRIPTS)
def test_measure_scripts_import_no_jax_and_no_cv2(script):
    """The port's measurement scripts in ``scripts/`` pull in no JAX,
    nothing of the JAX package and no cv2."""
    path = PKG.parent / "scripts" / f"{script}.py"
    out = subprocess.run([sys.executable, "-c", _SCRIPT_PROBE, str(path)],
                         check=True, capture_output=True, text=True,
                         cwd=PKG.parent).stdout.split("\n")
    assert out[:2] == ["[]", "True"]
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|cv2|piccolo_tpu)\b"
                         r"(?!_torch)", src, re.M)


@pytest.mark.parametrize("script,argv", [
    ("measure_tracking_cuda", ["--frames", "2"]),
    ("measure_serving_cuda", ["--mode", "sustained"]),
    ("measure_plan_lifecycle_cuda", ["--cache-dir", "unused"]),
    ("measure_sharded_coldstart_cuda", ["--exec-cache", "unused"]),
])
def test_measure_scripts_raise_without_a_card(monkeypatch, script, argv):
    """Without CUDA and without ``--device cpu`` a script raises before it
    does any work."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"measure_{script}", PKG.parent / "scripts" / f"{script}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def test_sources_never_import_jax_or_the_reference_package():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+piccolo_tpu\b(?!_torch)"
                     r"|from\s+piccolo_tpu\b(?!_torch))", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []


def test_sources_never_import_cv2_or_pil():
    """No exception since the port writes its GIFs itself
    (``harness/gif.py``)."""
    pat = re.compile(r"^\s*(import\s+(cv2|PIL)\b|from\s+(cv2|PIL)\b).*$", re.M)
    hits = [(str(p.relative_to(PKG)), m.group(0))
            for p in PKG.rglob("*.py") for m in pat.finditer(p.read_text())]
    assert hits == []


@pytest.mark.parametrize("entry", ["localize_query", "build_grid_plan",
                                   "build_hist_plan", "LocalizeService",
                                   "track_step", "track_step_prepped_fetched",
                                   "eval_synth", "demo"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    """Without CUDA, an entry point called without device= raises instead
    of running the plain path on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z3 = np.zeros((4, 3), np.float32)
    calls = {
        "localize_query": lambda: localize_query(
            np.zeros((8, 16, 3), np.float32), np.zeros((8, 16, 3), np.float32),
            z3, z3, z3, z3, np.ones(4, bool), np.zeros(3), np.ones(3)),
        "build_grid_plan": lambda: build_grid_plan(z3, z3, None, z3, z3, 8, 16),
        "build_hist_plan": lambda: build_hist_plan(z3, z3, z3, z3, 8, 16),
        "LocalizeService": lambda: LocalizeService(num_trans=4),
        "track_step": lambda: track_step(
            np.zeros((8, 16, 3), np.float32), z3, z3, z3[0], z3[0], z3[0],
            z3[0] + 1),
        "track_step_prepped_fetched": lambda: track_step_prepped_fetched(
            np.zeros((8, 16, 3), np.uint8), z3, z3, z3[0], z3[0], z3[0],
            z3[0] + 1),
        "eval_synth": lambda: eval_synth.main(["--rooms", "1"]),
        "demo": lambda: demo.main(["--points", "600"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
