"""Neither the harness nor the reference loads JAX or the JAX package, and
the reference loads nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "piccolo_tpu"}
JUDGES = ("reference", "judge", "scene", "roofline")


def _loaded(code: str, cwd: Path):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make(tmp_path)
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        f"sys.path.append({str(tiny.ROOT)!r})\n"
        "from benchmark import run, spec\n"
        "from pathlib import Path\n"
        f"root = Path({str(root)!r})\n"
        "run.run_cell(spec.load_spec(root), 'omniscenes.query', 4, 1.0, "
        "False, device='cpu', t0=time.time(), root=root, log=lambda *a: 0)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded(code, root)
    assert "piccolo_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        + "".join(f"import benchmark.{m}\n" for m in JUDGES)
        + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
        "\n")
    top = _loaded(code, tiny.ROOT)
    assert not top & (FORBIDDEN | {"piccolo_tpu_torch"})


def test_the_references_sources_import_only_torch_and_numpy():
    for m in JUDGES:
        tree = ast.parse((tiny.BENCH / f"{m}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or "."]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"piccolo_tpu_torch"}
