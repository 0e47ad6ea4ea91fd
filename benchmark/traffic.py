"""The one general traffic generator: closed-loop clients from a data file.

A traffic file (``traffic/<name>.json``) says what the clients send:

* ``"kind": "query"``: ``clients`` threads, each sending full queries back
  to back over ``poses`` panoramas at poses drawn from the seed; client
  ``c`` starts at pose ``c`` and steps by ``clients``, so every seed sends
  the same number of requests of the same size in another order.
* ``"kind": "track"``: ``streams`` camera streams, one thread each, each a
  smooth walk of ``frames`` panoramas (``step_m`` metres and ``step_deg``
  degrees of yaw a frame, with a sideways wobble of ``wobble_m``), played
  forward and back.  Set-up seeds each stream with one full query on its
  first frame; the window sends each next frame with ``prev_pose`` taken
  from the previous reply, as a tracking client does.

``trace_seconds`` bounds the traced run's window, which the profiler
records whole.

Every pose is drawn from the seed and every panorama is ray cast on the
device; the service receives uint8 images only.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

import numpy as np

from . import reference
from . import scene as scene_mod


def _walk(sc, rng, n: int, step_m: float, step_deg: float, wobble_m: float,
          z_range):
    """A walk of n poses that stays 0.25 m clear of occluders and 0.4 m
    inside the walls, or None."""
    t, ypr = scene_mod.scene_pose(sc, rng, z_range=z_range)
    heading = rng.random() * 2 * math.pi
    turn = math.radians(step_deg) * (1 if rng.random() < 0.5 else -1)
    half = np.asarray(sc.size[:2], np.float64) / 2 - 0.4
    ctr = np.asarray(sc.center, np.float64)
    poses = []
    for f in range(n):
        side = wobble_m * math.sin(f / 3.0)
        d = np.array([math.cos(heading), math.sin(heading)])
        pos = np.array(t, np.float64)
        pos[:2] += f * step_m * d + side * np.array([-d[1], d[0]])
        if np.any(np.abs(pos[:2] - ctr[:2]) > half):
            return None
        if not scene_mod.clear_of_occluders(sc, pos.astype(np.float32)):
            return None
        y = np.array([ypr[0] + f * turn, ypr[1], ypr[2]], np.float32)
        poses.append((pos.astype(np.float32), y))
    return poses


class Workload:
    """The cell's requests: images and ground truth, and the client loops
    that send them."""

    def __init__(self, traffic: Dict, sc, rng, hw, z_range, device):
        import torch

        self.kind = traffic["kind"]
        self.traffic = traffic
        self.images: List[np.ndarray] = []
        self.gt: List[tuple] = []
        self.streams: List[List[int]] = []

        def add(t, ypr):
            img = scene_mod.raycast_pano(sc, t, ypr, hw, device)
            self.images.append(img.cpu().numpy())
            self.gt.append((np.asarray(t, np.float64),
                            scene_mod.rot_from_ypr_np(ypr)))
            return len(self.images) - 1

        if self.kind == "query":
            for _ in range(int(traffic["poses"])):
                add(*scene_mod.scene_pose(sc, rng, z_range=z_range))
            self.clients = int(traffic["clients"])
        elif self.kind == "track":
            self.clients = int(traffic["streams"])
            for _ in range(self.clients):
                for _ in range(500):
                    walk = _walk(sc, rng, int(traffic["frames"]),
                                 float(traffic["step_m"]),
                                 float(traffic["step_deg"]),
                                 float(traffic.get("wobble_m", 0.0)), z_range)
                    if walk is not None:
                        break
                else:
                    raise RuntimeError("no walk fits the room")
                self.streams.append([add(t, y) for t, y in walk])
        else:
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prev: List[Dict] = []

    # -- set-up ------------------------------------------------------------

    def seed_streams(self, svc) -> None:
        """One full query on each stream's first frame: the pose a tracking
        client starts from."""
        self.prev = []
        for s in self.streams:
            out = svc.localize(self.images[s[0]])
            yaw, pitch, roll = reference.ypr_of(out["rot"])
            self.prev.append({"t": [float(x) for x in out["t"]],
                              "ypr": [yaw, pitch, roll]})
        self.pos = [0] * len(self.streams)
        self.dir = [1] * len(self.streams)

    # -- the loop ----------------------------------------------------------

    def _next(self, c: int, k: int):
        """(image index, prev pose or None) of client c's k-th request."""
        if self.kind == "query":
            return (c + k * self.clients) % len(self.images), None
        frames = self.streams[c]
        p, d = self.pos[c], self.dir[c]
        if not 0 <= p + d < len(frames):
            d = -d
        self.pos[c], self.dir[c] = p + d, d
        return frames[p + d], self.prev[c]

    def run(self, svc, seconds: float, records: List[Dict], k0: int = 0,
            grace: float = 60.0) -> tuple:
        """Closed loops for ``seconds``: each client sends its next request
        when its last one is answered.  Requests in flight at the close are
        awaited (up to ``grace`` seconds) and kept.  Returns the window's
        (start, end) wall times."""
        from torch.profiler import record_function

        lock = threading.Lock()
        t_start = time.time()
        t_end = t_start + seconds

        def client(c: int):
            k = k0
            while time.time() < t_end:
                idx, prev = self._next(c, k)
                rec = dict(client=c, image=idx, prev=prev,
                           tracked=prev is not None, t_issue=time.time())
                try:
                    with record_function("bench.request"):
                        out = (svc.localize(self.images[idx]) if prev is None
                               else svc.localize(self.images[idx],
                                                 prev_pose=prev))
                    rec.update(t_done=time.time(), t=np.asarray(out["t"]),
                               R=np.asarray(out["rot"]),
                               total_s=float(out["total_s"]),
                               time_s=float(out["time_s"]),
                               batched=int(out.get("batched", 1)))
                    if prev is not None:
                        ypr = out.get("ypr")
                        ypr = (reference.ypr_of(out["rot"]) if ypr is None
                               else [float(x) for x in ypr])
                        self.prev[c] = {"t": [float(x) for x in out["t"]],
                                        "ypr": list(ypr)}
                except Exception as exc:  # a failed request is recorded
                    rec.update(t_done=time.time(), error=repr(exc))
                with lock:
                    records.append(rec)
                k += 1

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(self.clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=max(0.0, t_end - time.time()) + grace)
        alive = [th for th in threads if th.is_alive()]
        if alive:
            raise RuntimeError(f"{len(alive)} clients still waiting "
                               f"{grace:.0f} s after the window closed")
        return t_start, t_end

