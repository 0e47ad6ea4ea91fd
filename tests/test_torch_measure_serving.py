"""The port's serving measurement script (``scripts/measure_serving_cuda.py``) against
the JAX package's (``scripts/measure_serving.py``, loaded unedited), on the
CPU.

  * Rooms, poses and query images: ``_make_scene``, the room-auto eval's
    rooms and ``_query_images`` bit for bit at every seed the modes use.
    The panoramas are splat renders of each framework, whose ``atan2`` may
    part in the last bit (ROADMAP Queue 3): at the 60,000-point room and
    128x256 one pixel in 32,768 differs, so there at least 99.99% of
    pixels are held equal.
  * Each in-process mode (``sustained``, ``room-auto`` over two small
    rooms, ``track-streams`` at K = 2) at a small size against the JAX
    script's run of the same mode: the same JSON keys, the port adding
    ``device``.  Both run the script's budget at 20 iterations.  The
    room-auto runs pick the same room on every query (the JAX mode held
    to the same two rooms and the same query seeds); the track-streams
    runs' median t_err lie within ``T_ERR_GAP`` of each other (measured
    1.3 mm apart at 3 frames, 2.4 mm at 4: each stream's lr-0.1 steps
    amplify ulps, ROADMAP Queue 3).
  * ``http`` once, in a process of its own: two ``--device cpu`` servers
    in turn on a free port, two requests each, and no ``cv2`` imported;
    its keys are the JAX mode's (read from its source: that mode needs
    ``cv2``).
  * ``coldstart`` with ``--exec-cache ''`` gives the service
    ``exec_cache_dir=None`` even where the default cache directory is set:
    the JAX script keeps its default there (``ADVICE.md``), the port does
    not.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import piccolo_tpu.serve as jserve
import piccolo_tpu.testing as jtesting
from piccolo_tpu_torch.kernels import _build
from piccolo_tpu_torch.utils import exec_cache

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SMALL = dict(points=3000, height=32)
NUM_ITER = 20
# the port's and the JAX package's track-streams median t_err at SMALL
T_ERR_GAP = 5e-3
# the port test's room-auto rooms
TWO_ROOMS = ("checker_a", "checker_b")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jscript():
    mod = _load("jax_measure_serving", "scripts/measure_serving.py")
    mod._CFG.update(exec_cache_dir=None, num_iter=NUM_ITER)
    return mod


@pytest.fixture(scope="module")
def tscript():
    mod = _load("port_measure_serving", "scripts/measure_serving_cuda.py")
    mod._CFG.update(exec_cache_dir=None, num_iter=NUM_ITER)
    return mod


def _jax_keys(mode: str) -> set:
    """The keys of the JSON line that the JAX script's ``mode`` function
    prints, from its source."""
    tree = ast.parse((ROOT / "scripts" / "measure_serving.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == mode)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    return {k.value for k in call.args[0].keys if k is not None}


@pytest.mark.parametrize("seed,npw,texture", [(3, 10000, "checker"),
                                              (3, 500, "checker"),
                                              (1, 500, "plain")])
def test_make_scene_bit_for_bit(jscript, tscript, seed, npw, texture):
    for got, want in zip(tscript._make_scene(seed, npw, texture),
                         jscript._make_scene(seed, npw, texture)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_room_auto_rooms_bit_for_bit(tscript):
    """The four rooms of the room-auto eval, as the JAX mode draws them."""
    npw = 3000 // 6
    rooms = tscript.make_rooms(3000)
    assert list(rooms) == ["plain", "checker_a", "checker_b", "cluttered"]
    for name, (seed, texture, cluttered) in tscript.ROOMS.items():
        rng = np.random.default_rng(seed)
        if cluttered:
            want = jtesting.make_cluttered_room(
                rng, n_per_wall=npw, size=tscript.SIZE, texture=texture)[:2]
        else:
            want = jtesting.make_room(rng, n_per_wall=npw, size=tscript.SIZE,
                                      texture=texture)
        for got, w in zip(rooms[name], want):
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("seed", [9, 99, 102, 7, 21])
def test_query_images_bit_for_bit(jscript, tscript, seed):
    xyz, rgb = jscript._make_scene(3, 500)
    want = jscript._query_images(xyz, rgb, 3, hw=(32, 64), seed=seed)
    got = tscript._query_images(xyz, rgb, 3, hw=(32, 64), seed=seed,
                                device="cpu")
    for (g_img, g_t), (w_img, w_t) in zip(got, want):
        assert g_img.dtype == w_img.dtype == np.uint8
        np.testing.assert_array_equal(g_t, w_t)
        np.testing.assert_array_equal(g_img, w_img)


def test_query_images_at_the_default_room(jscript, tscript):
    xyz, rgb = jscript._make_scene()
    want = jscript._query_images(xyz, rgb, 3, hw=(128, 256), seed=21)
    got = tscript._query_images(xyz, rgb, 3, hw=(128, 256), seed=21,
                                device="cpu")
    for (g_img, g_t), (w_img, w_t) in zip(got, want):
        np.testing.assert_array_equal(g_t, w_t)
        assert np.mean(np.all(g_img == w_img, axis=-1)) >= 0.9999
        assert np.abs(g_img.astype(int) - w_img).max() <= 2


def _jax_line(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_modes(jscript, tscript):
    """The JAX script's in-process modes at a small size: its rooms of 500
    points a wall and 32x64 panoramas.  Its room-auto mode runs over
    ``TWO_ROOMS`` alone: the other rooms are neither loaded nor queried, so
    the two rooms' queries draw the seeds that the port's run over them
    draws.  Each auto query's pick is recorded."""
    others = [xyz for name, (xyz, _) in tscript.make_rooms(3000).items()
              if name not in TWO_ROOMS]
    picks = []

    class TwoRooms(jserve.LocalizeService):
        def load_room(self, xyz, rgb, name=None, **kw):
            if name in TWO_ROOMS:
                return super().load_room(xyz, rgb, name=name, **kw)
            return None

        def localize(self, img, room=None, **kw):
            out = super().localize(img, room=room, **kw)
            if room == "auto":
                picks.append(out["room"])
            return out

    with pytest.MonkeyPatch.context() as mp:
        scene, images = jscript._make_scene, jscript._query_images
        mp.setattr(jscript, "_make_scene",
                   lambda seed=3, n_per_wall=500, texture="checker":
                   scene(seed, 500, texture))
        mp.setattr(jscript, "_query_images",
                   lambda xyz, rgb, n, hw=(32, 64), seed=9:
                   [] if any(np.array_equal(xyz, o) for o in others)
                   else images(xyz, rgb, n, (32, 64), seed))
        sustained = _jax_line(jscript.mode_sustained, 6)
        track = _jax_line(jscript.mode_track_streams, 2, 3, True, **SMALL)
        mp.setattr(jserve, "LocalizeService", TwoRooms)
        room_auto = _jax_line(jscript.mode_room_auto, probe=False, **SMALL)
    return dict(sustained=sustained, room_auto=room_auto,
                room_auto_picks=picks, track=track)


def test_sustained_keys(tscript, jax_modes):
    got = tscript.mode_sustained(6, CPU, **SMALL)
    assert set(got) == set(jax_modes["sustained"]) | {"device"}
    assert got["device"] == "cpu" and len(got["all_s"]) == 6
    assert got["first5_median_s"] > 0 and got["last5_median_s"] > 0


def test_room_auto_keys_over_two_rooms(tscript, jax_modes, capsys):
    got = tscript.mode_room_auto(CPU, probe=False, names=TWO_ROOMS, **SMALL)
    want = jax_modes["room_auto"]
    assert set(got) == set(want) | {"device"}
    assert got["total"] == want["total"] == 6 and len(got["auto_s"]) == 6
    assert got["probe"] == want["probe"] == "False"
    lines = capsys.readouterr().out.splitlines()
    # the JAX package's pick on every query
    picks = [re.search(r": picked (\w+),", ln).group(1) for ln in lines
             if ln.startswith("query ")]
    assert picks == jax_modes["room_auto_picks"]
    assert got["correct"] == want["correct"]
    routes = [ln for ln in lines if ln.startswith("room ")]
    # the CPU's auto admits no plan: both rooms on the gather engine
    assert sorted(routes) == ["room checker_a: stage 1 gather engine",
                              "room checker_b: stage 1 gather engine"]


def test_track_streams_keys(tscript, jax_modes):
    got = tscript.mode_track_streams(2, 3, True, dev=CPU, **SMALL)
    assert set(got) == set(jax_modes["track"]) | {"device"}
    # every tracked request counts once, under the size of its batch
    assert sum(got["batch_hist"].values()) == 6
    assert got["streams"] == 2 and got["frames_per_stream"] == 3
    assert abs(got["median_t_err_m"]
               - jax_modes["track"]["median_t_err_m"]) <= T_ERR_GAP


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_HTTP = """
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("m", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
out = m.mode_http(int(sys.argv[2]), torch.device("cpu"), requests=2,
                  points=3000, height=32)
print(json.dumps(dict(out, cv2="cv2" in sys.modules)))
"""


def test_http_two_cpu_servers_without_cv2(tmp_path):
    # the test and its two servers on few threads: the suite runs beside
    # other workers
    env = dict(os.environ, PICCOLO_EXEC_CACHE="", TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    # a session of its own: on a timeout its servers go with it
    proc = subprocess.Popen(
        [sys.executable, "-c", _HTTP,
         str(ROOT / "scripts" / "measure_serving_cuda.py"),
         str(_free_port())],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, stdout + stderr
    out = json.loads(stdout.strip().splitlines()[-1])
    assert out.pop("cv2") is False
    assert set(out) == _jax_keys("mode_http") | {"device"}
    assert out["default_median_s"] > 0 and out["prune_median_s"] > 0


@pytest.fixture
def library_store():
    """The test leaves the process's own library store as it found it."""
    store = _build.library_store()
    exec_cache.clear_memo()
    yield
    _build.use_store(store)
    exec_cache.clear_memo()


def test_coldstart_off_passes_no_cache(tscript, monkeypatch, tmp_path,
                                       library_store):
    """``--exec-cache ''`` is off even where the default directory is set;
    a directory is passed on as it is."""
    seen = []
    real = tscript._service

    def service(dev, **kw):
        seen.append(kw.get("exec_cache_dir", "missing"))
        return real(dev, **kw)

    default = tmp_path / "default_cache"
    monkeypatch.setitem(tscript._CFG, "exec_cache_dir", str(default))
    monkeypatch.setattr(tscript, "_service", service)
    off = tscript.mode_coldstart("", 3000, 32, CPU)
    assert seen == [None]
    assert off["warm"] is None and not default.exists()
    assert set(off) == _jax_keys("mode_coldstart") | {"warm", "store",
                                                       "device"}
    on_dir = tmp_path / "exec"
    on = tscript.mode_coldstart(str(on_dir), 3000, 32, CPU)
    assert seen == [None, str(on_dir)]
    # on the CPU the cache holds the JPEG codec alone
    assert len(on["warm"]["hits"]) + len(on["warm"]["built"]) == 1
    assert on["exec_cache"] is True and off["exec_cache"] is False
