"""The port's plan-lifecycle measurement script (``scripts/measure_plan_lifecycle_cuda.py``)
against the JAX package's (``scripts/measure_plan_lifecycle.py``, loaded
unedited), on the CPU, at a small room.

The CPU's ``auto`` admits no plan in either package, so the port's runs
force an f32 plan (the script's config with ``slab_init=True``):

  * ``--sync``: the plan is built in line by q0 and resident after every
    query, each query's route names it;
  * the background default: q0 runs the gather engine while the plan
    builds on a thread, and the plan is resident by the last query;
  * the JSON keys are the JAX run's (``--sync`` at the same size, where
    the JAX package runs the gather engine), the port adding ``routes``,
    ``plan`` and ``device``, and the two runs' median t_err lie within
    ``T_ERR_GAP`` (measured 0.5 mm apart: the lr-0.1 descent amplifies
    ulps, ROADMAP Queue 3).
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--points", "3000", "--height", "32", "--queries", "3"]
F32 = ["--device", "cpu"]
# the port's and the JAX package's median t_err over the three queries
T_ERR_GAP = 5e-3


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tscript():
    """The port's script, its config forcing an f32 plan on the CPU."""
    mod = _load("port_measure_plan_lifecycle",
                "scripts/measure_plan_lifecycle_cuda.py")
    make_config = mod.make_config
    mod.make_config = lambda **kw: make_config(**kw, slab_init=True)
    return mod


@pytest.fixture(scope="module")
def jax_sync(tmp_path_factory):
    mod = _load("jax_measure_plan_lifecycle",
                "scripts/measure_plan_lifecycle.py")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(["--cache-dir", str(tmp_path_factory.mktemp("jax_plans")),
                  "--sync"] + SMALL)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sync(tscript, tmp_path_factory):
    return tscript.main(["--cache-dir", str(tmp_path_factory.mktemp("sync")),
                         "--sync"] + SMALL + F32)


def test_sync_plan_resident_from_q0(sync, jax_sync):
    got = sync
    assert set(got) == set(jax_sync) | {"routes", "plan", "device"}
    assert got["mode"] == jax_sync["mode"] == "sync+disk_auto"
    assert abs(got["median_t_err_m"]
               - jax_sync["median_t_err_m"]) <= T_ERR_GAP
    assert got["plan_resident_after_query"] == [True, True, True]
    assert all(r.startswith("stage 1 f32 slab plan") for r in got["routes"])
    assert [p["route"] for p in got["plan"]] == ["stage 1 f32 slab plan"]
    # the disk cache's auto is off: nothing written
    assert got["cache_entries"] == 0 and got["device"] == "cpu"
    assert len(got["sec_per_query"]) == 3


def test_background_plan_resident_by_the_last_query(tscript, tmp_path):
    got = tscript.main(["--cache-dir", str(tmp_path)] + SMALL + F32)
    assert got["mode"] == "background+disk_auto"
    resident = got["plan_resident_after_query"]
    assert resident[-1] is True
    # once resident it stays, and the queries after it run the kernel
    first = resident.index(True)
    assert all(resident[first:])
    assert got["routes"][0].startswith("stage 1 gather engine")
    assert all(r.startswith("stage 1 f32 slab plan")
               for r in got["routes"][first + 1:])


def test_disk_arm_writes_then_loads(tscript, sync, tmp_path):
    """``--disk`` twice on one directory: the first run writes the plan
    (under the 3 GB persist bound), the second loads it for q0 and answers
    as the ``--sync`` run does on the plan it built."""
    argv = ["--cache-dir", str(tmp_path), "--disk"] + SMALL + F32
    first = tscript.main(argv)
    assert first["mode"] == "background+disk"
    assert first["cache_entries"] == 1
    second = tscript.main(argv)
    assert second["cache_entries"] == 1
    assert second["plan_resident_after_query"] == [True, True, True]
    assert second["median_t_err_m"] == sync["median_t_err_m"]
