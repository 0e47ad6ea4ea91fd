"""The port's ``init_distributed`` (``parallel/sharding.py``): its argument
contract with ``torch.distributed.init_process_group`` faked, as
tests/test_distributed.py fakes JAX's, and the real thing: two OS
processes join one ``gloo`` group on localhost and run the halves of a
``query_shards`` CLI sweep at once, whose merged CSV must equal the
one-process sweep on every column but time (tests/test_multiprocess.py's
check).
"""

import csv
import os
import socket
import subprocess
import sys
import warnings

import pytest
import torch
import torch.distributed as dist

from piccolo_tpu_torch.parallel import init_distributed

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CLUSTER_VARS = ("MASTER_ADDR", "WORLD_SIZE", "TORCHELASTIC_RUN_ID",
                "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "SLURM_STEP_NODELIST")


@pytest.fixture
def fake_init(monkeypatch):
    calls = []
    state = {}

    def init_process_group(backend=None, init_method=None, world_size=-1,
                           rank=-1, **kw):
        calls.append(dict(backend=backend, init_method=init_method,
                          world_size=world_size, rank=rank))
        state["rank"] = rank

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(dist, "is_initialized", lambda: "rank" in state)
    monkeypatch.setattr(dist, "get_rank", lambda: state["rank"])
    return calls


def test_explicit_cluster_args_propagate(fake_init):
    assert init_distributed("10.0.0.1:1234", 4, 2) == 2
    assert fake_init == [dict(backend="nccl",
                              init_method="tcp://10.0.0.1:1234",
                              world_size=4, rank=2)]


def test_cpu_uses_gloo_and_urls_pass_through(fake_init):
    init_distributed("tcp://10.0.0.1:1234", 2, 1, device="cpu")
    assert fake_init == [dict(backend="gloo",
                              init_method="tcp://10.0.0.1:1234",
                              world_size=2, rank=1)]


def test_coordinator_only_is_forwarded(fake_init):
    """coordinator_address alone reaches torch, which then names what is
    missing (an initialization error propagates)."""
    init_distributed("10.0.0.1:1234")
    assert fake_init == [dict(backend="nccl",
                              init_method="tcp://10.0.0.1:1234",
                              world_size=-1, rank=-1)]


def test_explicit_errors_propagate(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="connection refused"):
        init_distributed("10.0.0.1:1234", 2, 0, device="cpu")


def test_single_process_noop(fake_init):
    assert init_distributed(num_processes=1) == 0
    assert fake_init == []


def test_partial_args_rejected(fake_init):
    with pytest.raises(ValueError, match="process_id without"):
        init_distributed(process_id=0)
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=4)
    assert fake_init == []


def test_auto_detect_reads_the_environment(fake_init):
    assert init_distributed(device="cpu") == -1  # the fake's env:// rank
    assert fake_init == [dict(backend="gloo", init_method="env://",
                              world_size=-1, rank=-1)]


def test_auto_detect_failure_is_silent_without_cluster_env(monkeypatch):
    def boom(*a, **kw):
        raise ValueError("environment variable RANK expected, but not set")

    monkeypatch.setattr(dist, "init_process_group", boom)
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any warning -> failure
        assert init_distributed() == 0


def test_auto_detect_failure_warns_loudly_with_cluster_env(monkeypatch,
                                                           capsys):
    def boom(*a, **kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    with pytest.warns(RuntimeWarning, match="1/Nth"):
        assert init_distributed() == 0
    assert "MASTER_ADDR" in capsys.readouterr().err
    # strict: the misconfiguration is fatal
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        init_distributed(strict=True)


_WORKER = """
import sys
idx, nproc = int(sys.argv[1]), int(sys.argv[2])
coord, cfg, log = sys.argv[3], sys.argv[4], sys.argv[5]
import torch
import torch.distributed as dist
torch.set_num_threads(1)

from piccolo_tpu_torch.parallel import init_distributed

got = init_distributed(coord, nproc, idx, device="cpu")
assert got == idx == dist.get_rank(), (got, idx)
assert dist.get_world_size() == nproc
assert dist.get_backend() == "gloo"

from piccolo_tpu_torch.main import main

main(["--config", cfg, "--log", log, "--no-tensorboard", "--device", "cpu",
      "--override",
      f"query_shards={dist.get_world_size()},query_shard_index={got}"])
dist.barrier()  # both halves are written
dist.destroy_process_group()
print("WORKER_OK", idx, flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _read_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_two_process_gloo_sweep_matches_single_process(tmp_path):
    """Two processes, one localhost rendezvous, the sweep's halves at once;
    each worker has 240 s."""
    from piccolo_tpu_torch.main import main as tmain
    from piccolo_tpu_torch.testing import write_synth_stanford

    root = str(tmp_path / "data")
    write_synth_stanford(root, rooms=1, queries=4, points=8000, height=64,
                         seed=5, oracle="raycast")
    cfg = str(tmp_path / "cfg.ini")
    with open(cfg, "w") as f:
        f.write(f"""[Default]
dataset = Stanford2D-3D-S
data_root = {root}
num_trans = 8
xy_only = True
yaw_only = True
z_prior = None
num_yaw = 4
num_intermediate = 6
num_input = 3
num_split_h = 2
num_split_w = 4
lr = 0.05
num_iter = 15
""")
    worker_py = str(tmp_path / "worker.py")
    with open(worker_py, "w") as f:
        f.write(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in CLUSTER_VARS:
        env.pop(var, None)
    coord = f"localhost:{_free_port()}"
    procs, logs = [], []
    for idx in range(2):
        log = str(tmp_path / f"shard{idx}")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, worker_py, str(idx), "2", coord, cfg, log],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for idx, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {idx} failed (rc={rc}):\n{out}\n{err}"
        assert f"WORKER_OK {idx}" in out

    ref_log = str(tmp_path / "ref")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers' count
    try:
        tmain(["--config", cfg, "--log", ref_log, "--no-tensorboard",
               "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    header, ref_rows = _read_rows(os.path.join(ref_log,
                                               "stanford_results.csv"))
    shard_rows, names = [], []
    for log in logs:
        h, rows = _read_rows(os.path.join(log, "stanford_results.csv"))
        assert h == header
        shard_rows.extend(rows)
        names.append({r[1] for r in rows})
    # the shards partition the queries: disjoint, jointly complete
    assert names[0] & names[1] == set() and all(names)
    assert names[0] | names[1] == {r[1] for r in ref_rows}
    t_col = header.index("time (s)")

    def key(r):
        return r[1]

    merged = sorted(shard_rows, key=key)
    want = sorted(ref_rows, key=key)
    assert len(merged) == len(want) == 4
    for got, ref in zip(merged, want):
        assert ([c for i, c in enumerate(got) if i != t_col]
                == [c for i, c in enumerate(ref) if i != t_col])
