"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; this module finds their files by those names
(``configs/<config>.json``, ``traffic/<traffic>.json``) and each per-layer
metric's reader (``metrics/<metric>.py``).  A later change adds a cell, a
configuration, a traffic mix or a metric by adding files and entries, and
edits nothing here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_spec(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: Dict, workload: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def config_entry(spec: Dict, name: str) -> Dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_config(spec: Dict, name: str, root: Path = ROOT) -> Dict:
    with open(root / config_entry(spec, name)["file"]) as f:
        return json.load(f)


def load_traffic(name: str, here: Path = HERE) -> Dict:
    with open(here / "traffic" / f"{name}.json") as f:
        return json.load(f)


def end_to_end(spec: Dict, workload: str) -> List[Dict]:
    """The cell's end-to-end metrics: those without a ``workloads`` list and
    those whose list names the cell."""
    return [m for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(spec: Dict, workload: str) -> List[Dict]:
    """The per-layer metrics read in this cell: those whose ``workloads``
    list names it, and those without a list wherever the cell reports the
    metric they move."""
    moved = {m["name"] for m in end_to_end(spec, workload)}
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif m["moves"] in moved:
            out.append(m)
    return out


def reader(metric: str, here: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", metric)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read
