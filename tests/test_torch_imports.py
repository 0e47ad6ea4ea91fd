"""piccolo_tpu_torch stands alone: it imports no JAX and nothing of
piccolo_tpu, and its entry points refuse to run on the CPU unless asked."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import piccolo_tpu_torch
from piccolo_tpu_torch import build_grid_plan, build_hist_plan, localize_query

PKG = pathlib.Path(piccolo_tpu_torch.__file__).resolve().parent

_PROBE = """
import importlib, pkgutil, sys
import piccolo_tpu_torch
for m in pkgutil.walk_packages(piccolo_tpu_torch.__path__, "piccolo_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "piccolo_tpu"))
print(len([k for k in sys.modules if k.startswith("piccolo_tpu_torch.")]))
print(bad)
"""


def test_import_loads_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], check=True,
                         capture_output=True, text=True,
                         cwd=PKG.parent).stdout.split("\n")
    assert int(out[0]) >= 36  # every submodule was imported
    assert out[1] == "[]"


def test_sources_never_import_jax_or_the_reference_package():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+piccolo_tpu\b(?!_torch)"
                     r"|from\s+piccolo_tpu\b(?!_torch))", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []


@pytest.mark.parametrize("entry", ["localize_query", "build_grid_plan",
                                   "build_hist_plan"])
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
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
