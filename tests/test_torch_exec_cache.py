"""The port's executable cache (``utils/exec_cache.py``) on the CPU.

The cache is the process's library store (``kernels/_build.BuildDir``)
pointed at a directory.  On the CPU it holds the one library the port
builds there, the JPEG codec (the CUDA kernels are built and cached on
the card: ``chip_smoke.py``).  A fresh directory builds it, the next
warm-up hits, an entry whose bytes do not match its digest (or that lost
its digest) is built again, through the cache or through the plain build
directory, the key changes with the platform fingerprint, a failed build
raises, eviction keeps the directory under its budget, and a CLI sweep
with the cache gives the rows of a sweep without it.
"""

import csv
import os

import numpy as np
import pytest
import torch

from piccolo_tpu_torch.harness import imaging
from piccolo_tpu_torch.kernels import _build
from piccolo_tpu_torch.utils import exec_cache

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def library_store():
    """Each test starts from, and leaves, the process's own store."""
    store = _build.library_store()
    exec_cache.clear_memo()
    yield
    _build.use_store(store)
    exec_cache.clear_memo()


def _codec_entry(d):
    names = [n for n in os.listdir(d) if n.endswith(".so")]
    assert len(names) == 1 and names[0].startswith("jpeg_codec-")
    return os.path.join(d, names[0])


def test_miss_then_hit_then_same_bits(tmp_path):
    img = (np.random.default_rng(0).random((24, 40, 3)) * 255).astype(np.uint8)
    want = imaging.jpeg_decode(imaging.jpeg_encode(img, 90))
    first = exec_cache.warm(tmp_path, "cpu")
    assert first["built"] and not first["hits"] and not first["rebuilt"]
    path = _codec_entry(tmp_path)
    assert os.path.exists(path + ".sha256")
    # the same process again: the memo, no second look
    assert exec_cache.warm(tmp_path, "cpu") is first
    exec_cache.clear_memo()
    second = exec_cache.warm(tmp_path, "cpu")
    assert second["hits"] == [os.path.basename(path)]
    assert not second["built"] and not second["rebuilt"]
    np.testing.assert_array_equal(
        imaging.jpeg_decode(imaging.jpeg_encode(img, 90)), want)
    assert "1 hit(s), 0 built" in exec_cache.describe(second)


def _build_codec(d, route):
    """Build or find the codec in ``d``: through the executable cache, or
    through the plain build directory (the default path); returns the
    store's (hits, built, rebuilt) of this call."""
    if route == "exec_cache":
        exec_cache.clear_memo()
        stats = exec_cache.warm(d, "cpu")
        return stats["hits"], stats["built"], stats["rebuilt"]
    store = _build.BuildDir(d)
    _build.use_store(store)
    _build.build_sources([_build.host_job(imaging.CODEC_SRC)])
    return store.hits, store.built_names, store.rebuilt


@pytest.mark.parametrize("route", ["exec_cache", "build_dir"])
@pytest.mark.parametrize("damage", ["bytes", "digest", "truncate"])
def test_corrupt_entry_rebuilds(tmp_path, damage, route):
    _build_codec(tmp_path, route)
    path = _codec_entry(tmp_path)
    good = open(path, "rb").read()
    if damage == "bytes":
        with open(path, "r+b") as f:
            f.seek(len(good) // 2)
            f.write(b"\x00garbage\x00")
    elif damage == "digest":
        os.unlink(path + ".sha256")
    else:
        with open(path, "wb") as f:
            f.write(good[:100])
    hits, built, rebuilt = _build_codec(tmp_path, route)
    assert rebuilt == [os.path.basename(path)]
    assert not hits and not built
    assert _codec_entry(tmp_path) == path
    assert _build_codec(tmp_path, route)[0] == [os.path.basename(path)]


def test_key_covers_the_platform(tmp_path, monkeypatch):
    store = _build.BuildDir(tmp_path)
    src = imaging.CODEC_SRC
    a = store.target(src, _build.HOST_FLAGS)
    assert a == store.target(src, _build.HOST_FLAGS)
    assert a != store.target(src, _build.HOST_FLAGS + ("-g",))
    monkeypatch.setattr(_build, "fingerprint", lambda cuda: "machine=other")
    assert store.target(src, _build.HOST_FLAGS) != a
    # a CUDA source keys on the CUDA fingerprint, not the host one
    seen = []
    monkeypatch.setattr(_build, "fingerprint",
                        lambda cuda: seen.append(cuda) or "x")
    store.target(_build.CSRC / "block_histogram.cu", _build.NVCC_FLAGS)
    assert seen == [True]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a compiler that fails is an error, and the cache
    keeps no entry."""
    _build.use_dir(tmp_path)
    monkeypatch.setattr(_build, "fingerprint", lambda cuda: "test")
    with pytest.raises(RuntimeError, match="the build of jpeg_codec.cpp"):
        _build.build_sources([(imaging.CODEC_SRC, "false",
                               _build.HOST_FLAGS)])
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".so")]


def test_evict_lru_keeps_the_budget(tmp_path):
    for i, size in enumerate((100, 200, 300, 400)):
        p = tmp_path / f"lib{i}-x.so"
        p.write_bytes(b"\0" * size)
        (tmp_path / f"lib{i}-x.so.sha256").write_text("d")
        os.utime(p, (1000 + i, 1000 + i))
    (tmp_path / "other.txt").write_bytes(b"\0" * 5000)
    # oldest first, never the kept entry
    assert exec_cache.evict_lru(str(tmp_path), 750, keep="lib0-x.so") == 2
    left = sorted(n for n in os.listdir(tmp_path) if n.endswith(".so"))
    assert left == ["lib0-x.so", "lib3-x.so"]
    assert not (tmp_path / "lib1-x.so.sha256").exists()
    assert (tmp_path / "other.txt").exists()
    assert exec_cache.evict_lru(str(tmp_path / "missing"), 0) == 0


def test_aot_call_warms_then_calls(tmp_path):
    got = exec_cache.aot_call(lambda a, b, device: a + b, ("b",),
                              str(tmp_path), 2, b=3, device="cpu")
    assert got == 5
    assert _build.library_store().path == tmp_path.resolve()
    _codec_entry(tmp_path)


def _csv_rows(log):
    with open(os.path.join(log, "stanford_results.csv"), newline="") as f:
        rows = list(csv.reader(f))
    t_col = rows[0].index("time (s)")
    return [[c for i, c in enumerate(r) if i != t_col] for r in rows]


def test_cli_sweep_hits_with_equal_rows(tmp_path, capsys):
    """Two sweeps with one exec_cache_dir (the first builds, the second
    hits) and one without it: equal rows but for time."""
    from piccolo_tpu_torch.main import main as tmain
    from piccolo_tpu_torch.testing import write_synth_stanford

    root = str(tmp_path / "data")
    write_synth_stanford(root, rooms=1, queries=2, points=6000, height=64,
                         seed=3, oracle="raycast")
    ini = tmp_path / "cfg.ini"
    ini.write_text(f"""[Default]
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
    base = ["--config", str(ini), "--no-tensorboard", "--device", "cpu"]
    cache = f"exec_cache_dir={tmp_path / 'exec'}"
    outs = []
    for name, ov in (("a", cache), ("b", cache), ("plain", None)):
        exec_cache.clear_memo()
        tmain(base + ["--log", str(tmp_path / name)]
              + (["--override", ov] if ov else []))
        outs.append(capsys.readouterr().out)
    assert "0 hit(s), 1 built" in outs[0]
    assert "1 hit(s), 0 built" in outs[1]
    assert "exec cache" not in outs[2]
    want = _csv_rows(str(tmp_path / "plain"))
    assert len(want) == 3
    assert _csv_rows(str(tmp_path / "a")) == want
    assert _csv_rows(str(tmp_path / "b")) == want
