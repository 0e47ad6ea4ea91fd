"""Persistent localization service (port of piccolo_tpu/serve.py).

The reference is a batch evaluation script; deployments instead keep a
card warm and answer single localization queries.  The service holds its
rooms' device state resident (padded cloud, candidate grids, slab plans)
and runs each query through the harness's own fused path
(``harness.localize._run_fused``), so served poses equal the batch CLI's.
A minimal stdlib HTTP JSON API sits on top.  No reference counterpart.

Usage (library)::

    svc = LocalizeService(num_trans=50, num_yaw=8, yaw_only=True)
    svc.load_room(xyz, rgb)                  # or svc.load_room_pcd(path)
    out = svc.localize(image)                # (H, W, 3) RGB uint8/float
    out["t"], out["rot"], out["loss"], out["time_s"], out["total_s"]

Usage (HTTP)::

    python -m piccolo_tpu_torch.serve --config configs/stanford.ini \\
        --pcd /data/room.txt --port 8321 [--device cpu]
    curl -X POST localhost:8321/localize -d '{"image_path": "pano.png"}'

Tracked requests (``prev_pose``) run one warm-started descent; under
``track_batch`` the tracked requests queued for one room are drained as one
batched descent.  ``room="auto"`` ranks the resident rooms by full queries,
by a probe per room, or (``room_auto_probe = "batched"``) by one probe over
every room (``probe.py``).

While a ``torch.profiler`` session records, each request is a
``service.request`` span with its own id, and its prep, compute-lock wait,
solve and result copy (and a tracked frame's queue wait and batch) are
spans under it (``utils.profiling``); the reply's ``route`` names the
stages' route and ``/healthz`` the plan bytes each card holds.

The service runs on the card (``device="cuda"``, the default) unless the
caller passes ``device="cpu"``.  Two config keys use more devices, and
exclude each other: ``n_devices`` shards each query over a ('cand',
'point') mesh (``parallel``), and ``query_devices`` holds one replica of
every room on each of N cards and answers whole requests round-robin on
them, each card under its own compute lock (on the CPU both count logical
devices).  The executable cache (``exec_cache_dir``, ``--exec-cache``)
builds or loads the process's kernel libraries and JPEG codec when the
service starts (``utils.exec_cache``), so a restart skips the compilers.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import contextvars
import json
import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Dict, Optional

import numpy as np
import torch

from .config import cfg_get, make_config, parse_ini
from .device import as_tensor, resolve_device
from .harness.localize import (
    _drop_slab_plans,
    _FusedGrids,
    _maybe_mesh,
    _order_bounds,
    _pad_cloud,
    _run_fused,
    _use_fused,
    get_init_dict,
    prepare_omniscenes_images,
    prepare_stanford_images,
)
from .utils import profiling

__all__ = ["LocalizeService", "ServiceOverloaded", "serve_forever", "main"]


class ServiceOverloaded(RuntimeError):
    """Raised when admission would exceed ``max_pending`` in-flight
    requests; the HTTP layer answers 503 with Retry-After."""


_CFG_DEFAULTS = dict(
    dataset="Stanford2D-3D-S",
    sample_rate=1,
    out_of_room_quantile=0.05,
)


class LocalizeService:
    """Resident rooms; ``localize()`` per query panorama.

    Construct with a config namedtuple (``parse_ini`` output) or keyword
    config values; every key the batch harness honors works here (init
    budget, descent_table, slab_init, n_devices, ...).  ``device``: the
    card (``"cuda"``, the default; raises without one) or ``"cpu"``.
    ``query_devices = N`` (or ``"all"``) puts a replica of each room on N
    cards and answers requests on them in turn.
    """

    def __init__(self, cfg=None, max_rooms: int = 1, max_pending: int = 8,
                 device="cuda", **cfg_kwargs):
        if cfg is None:
            cfg = make_config(**{**_CFG_DEFAULTS, **cfg_kwargs})
        elif cfg_kwargs:
            raise ValueError("pass cfg or keyword config values, not both")
        self.cfg = cfg
        self.init_dict = get_init_dict(cfg)
        if not _use_fused(cfg, self.init_dict):
            # the staged path's extras (init-only subsample, fused=False)
            # have no serving counterpart
            raise ValueError(
                "serving runs the fused pipeline only; drop "
                "sample_rate_for_init / unknown criterion (or fused="
                "False) from the config"
            )
        if cfg_get(cfg, "visualize", False):
            raise ValueError(
                "serving returns no per-iteration artifacts; drop "
                "visualize=True from the config"
            )
        dev = resolve_device(device)
        self.exec_cache = None  # what the executable cache found, if on
        exec_dir = cfg_get(cfg, "exec_cache_dir")
        if exec_dir:
            from .utils import exec_cache

            self.exec_cache = exec_cache.warm(exec_dir, dev)
        self._devices = self._resolve_query_devices(cfg, dev)
        # n_devices: each query sharded over a mesh; its rooms live on the
        # mesh's lead device
        self.mesh = _maybe_mesh(cfg, dev)
        if self.mesh is not None:
            self._devices = [self.mesh.lead]
        self.device = self._devices[0]
        # one compute lock per query device: requests prep on their own
        # threads while one holds the card; the room registry has its own
        # lock so health checks and loads never wait out a query
        self._compute_locks = [threading.Lock() for _ in self._devices]
        self._rr_lock = threading.Lock()
        self._rr = 0
        self._rooms_lock = threading.Lock()
        # LRU of resident rooms; eviction drops a room's plans promptly (a
        # room evicted mid-query lives on through the query's references)
        self._rooms: "OrderedDict[str, Dict]" = OrderedDict()
        self._max_rooms = max(1, int(max_rooms))
        # admission bound: beyond max_pending admitted-but-unfinished
        # requests, localize() raises ServiceOverloaded (HTTP 503)
        self._max_pending = max(1, int(max_pending))
        self._pending = 0
        self._pending_lock = threading.Lock()
        # track_batch: tracked requests queued per device, drained as one
        # batch by whichever request next takes the compute lock
        self._track_queues = [deque() for _ in self._devices]
        self._track_qlocks = [threading.Lock() for _ in self._devices]
        # room_auto_probe = "batched": the probe state per device, keyed by
        # the resident set it was built from
        self._batched_probes: Dict[int, tuple] = {}

    @staticmethod
    def _resolve_query_devices(cfg, dev: torch.device):
        """One device per query-parallel replica: ``[dev]`` unless
        ``query_devices`` asks for N > 1 (``"all"``: every visible card;
        on the CPU, N logical devices)."""
        qd = cfg_get(cfg, "query_devices")
        if qd in (None, 0, 1):
            return [dev]
        if cfg_get(cfg, "n_devices") not in (None, 0, 1):
            raise ValueError(
                "query_devices (round-robin queries over cards) and "
                "n_devices (shard each query over a mesh) are mutually "
                "exclusive")
        if dev.type != "cuda":
            if qd == "all":
                raise ValueError("query_devices='all' counts visible cards; "
                                 "on the CPU give a number of replicas")
            return [dev] * int(qd)
        visible = torch.cuda.device_count()
        n = visible if qd == "all" else int(qd)
        if not 2 <= n <= visible:
            raise ValueError(
                f"query_devices={qd} but {visible} devices are visible")
        return [torch.device("cuda", i) for i in range(n)]

    # -- health ------------------------------------------------------------

    @property
    def busy(self) -> bool:
        """True while a request holds the device."""
        return any(lk.locked() for lk in self._compute_locks)

    @property
    def devices(self) -> int:
        """Query-parallel device count (1 without ``query_devices``)."""
        return len(self._devices)

    @property
    def busy_devices(self) -> int:
        return sum(lk.locked() for lk in self._compute_locks)

    @property
    def pending(self) -> int:
        """Admitted, unfinished requests (prepping, waiting, or computing)."""
        with self._pending_lock:
            return self._pending

    @property
    def max_pending(self) -> int:
        return self._max_pending

    # -- room management ---------------------------------------------------

    def load_room(self, xyz: np.ndarray, rgb: np.ndarray,
                  name: str = "<arrays>",
                  warm_shape: Optional[tuple] = None) -> None:
        """Stage a colored cloud ((N, 3) xyz metres, (N, 3) rgb in [0, 1]).

        ``warm_shape=(H, W)``: run one throwaway query at that panorama
        shape now, so the room's slab plan builds (and the kernels load) at
        load time and the first real query runs at steady-state latency.
        """
        if name == "auto":
            raise ValueError(
                'room name "auto" is reserved for localize(room="auto") '
                "auto-selection — pick another name"
            )
        xyz = np.asarray(xyz, np.float32)
        rgb = np.asarray(rgb, np.float32)
        lo, hi = _order_bounds(
            xyz, cfg_get(self.cfg, "out_of_room_quantile", 0.05))
        caches = []
        for dev in self._devices:  # one replica per query device
            xyz_d, rgb_d, mask_d = _pad_cloud(xyz, rgb, dev)
            caches.append(dict(
                pcd=name, xyz_np=xyz, rgb_np=rgb, xyz=xyz_d, rgb=rgb_d,
                mask=mask_d, lo=lo, hi=hi, device=dev,
                grids=_FusedGrids(xyz, self.init_dict, dev)))
        with self._rooms_lock:
            self._rooms.pop(name, None)
            self._rooms[name] = caches
            while len(self._rooms) > self._max_rooms:
                _, evicted = self._rooms.popitem(last=False)
                for c in evicted:
                    _drop_slab_plans(c)
        if warm_shape is not None:
            H, W = warm_shape
            noise = np.random.default_rng(0).integers(
                0, 256, (int(H), int(W), 3), dtype=np.uint8)
            for di in range(len(self._devices)):  # every device warms
                self._localize_checked(noise, room=name, device_index=di)

    def load_room_pcd(self, path: str, dataset: Optional[str] = None) -> None:
        """Load a room from an ``x y z r g b`` text cloud (either dataset's
        format, reference data_utils.py:16,138)."""
        from . import data as data_mod

        ds = dataset or cfg_get(self.cfg, "dataset", "Stanford2D-3D-S")
        reader = (data_mod.read_omniscenes if "mni" in ds
                  else data_mod.read_stanford)
        xyz, rgb = reader(path, cfg_get(self.cfg, "sample_rate", 1))
        self.load_room(xyz.astype(np.float32), rgb.astype(np.float32), path)

    @property
    def room(self) -> Optional[str]:
        """Most recently used room name (None before any load)."""
        with self._rooms_lock:
            return next(reversed(self._rooms)) if self._rooms else None

    @property
    def rooms(self):
        """Resident room names, least- to most-recently used."""
        with self._rooms_lock:
            return list(self._rooms)

    # -- query -------------------------------------------------------------

    def localize(self, image: np.ndarray, room: Optional[str] = None,
                 prev_pose=None, recover_above: Optional[float] = None) -> Dict:
        """Localize one panorama against a resident room.

        ``image``: (H, W, 3) RGB, uint8 or float in [0, 1] (floats are
        requantized to uint8, the CLI's decode path, so served results
        equal the batch harness's).  ``room`` selects a resident room
        (default: the most recently used); ``room="auto"`` picks the room
        whose localization loss is lowest and adds ``room_scores``
        (``_select_room``).  Preprocessing is the harness's own per-query
        prep.  Under ``query_devices`` requests take the devices in turn.

        Returns a dict with the winner pose (``t`` (3,), ``rot`` (3, 3)),
        its ``loss``, ``winner``, the candidates' ``cand_loss``,
        ``time_s`` (the reference's CSV timer: main resize + solve),
        ``total_s`` (in-service latency, all prep and the result copy
        included), ``room``, ``device_index`` (the query device that
        answered) and, for a full query, ``route`` (the stages' route, as
        the CLI prints it per query).

        ``prev_pose`` (``{"t": [x, y, z], "ypr": [yaw, pitch, roll]}``, the
        fields a previous reply gives) switches the request to tracking: one
        warm-started descent replaces the full pipeline; the client carries
        the pose between frames.  ``recover_above``: when the tracked loss
        exceeds it (tracking lost), the same request falls back to the full
        pipeline and the reply sets ``recovered``.  ``room="auto"`` rejects
        ``prev_pose``.
        """
        return self._localize_checked(image, room, prev_pose=prev_pose,
                                      recover_above=recover_above)

    def _localize_checked(self, image: np.ndarray, room: Optional[str],
                          prev_pose=None,
                          recover_above: Optional[float] = None,
                          device_index: Optional[int] = None) -> Dict:
        if not self._rooms:
            raise RuntimeError("no room loaded — call load_room[_pcd] first")
        img = np.asarray(image)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) RGB image, got {img.shape}")
        if img.dtype != np.uint8:
            img = np.clip(np.round(np.asarray(img, np.float32) * 255.0),
                          0, 255).astype(np.uint8)

        with self._pending_lock:
            if self._pending >= self._max_pending:
                raise ServiceOverloaded(
                    f"{self._pending} requests already in flight "
                    f"(max_pending={self._max_pending}); retry later"
                )
            self._pending += 1
        try:
            return self._localize_admitted(img, room, device_index,
                                           prev_pose=prev_pose,
                                           recover_above=recover_above)
        finally:
            with self._pending_lock:
                self._pending -= 1

    def _prepare(self, img: np.ndarray, cache: Dict):
        """The harness's own per-query prep for this service's dataset."""
        with profiling.span("service.prep"):
            if "mni" in cfg_get(self.cfg, "dataset", "Stanford2D-3D-S"):
                _, img_init, img_main, rgb_used, prep_timed = (
                    prepare_omniscenes_images(self.cfg, img, cache))
            else:
                img_init, img_main, rgb_used, prep_timed = (
                    prepare_stanford_images(self.cfg, img, cache))
        return img_init, img_main, rgb_used, prep_timed

    @contextlib.contextmanager
    def _holding(self, device_index: int):
        """The device's compute lock, its wait a ``service.lock_wait``
        span."""
        lock = self._compute_locks[device_index]
        with profiling.span("service.lock_wait"):
            lock.acquire()
        try:
            yield
        finally:
            lock.release()

    _PLAN_KEY_HEADS = ("slab_plan", "hist_plan", "slab_plan_sharded",
                       "hist_plan_sharded")

    def plan_bytes(self, exclude_cache=None,
                   device_index: Optional[int] = None) -> Dict[str, int]:
        """Device memory the resident rooms' plans hold, by card: a plan on
        one device counts on that device, a sharded plan counts what it
        holds on each card of its mesh (``card_bytes``).  Every replica by
        default; ``device_index`` and ``exclude_cache`` narrow it to one
        replica's rooms other than one."""
        with self._rooms_lock:
            rooms = list(self._rooms.values())
        held: Dict[str, int] = {}
        for caches in rooms:
            for c in (caches if device_index is None
                      else [caches[device_index]]):
                if c is exclude_cache:
                    continue
                for k, v in list(c.items()):
                    if not (isinstance(k, tuple) and k
                            and k[0] in self._PLAN_KEY_HEADS):
                        continue
                    by_card = getattr(v, "card_bytes", None)
                    if by_card is None:
                        by_card = {str(c["device"]):
                                   int(getattr(v, "nbytes", 0) or 0)}
                    for card, n in by_card.items():
                        held[card] = held.get(card, 0) + int(n)
        return held

    def _resident_plan_bytes(self, exclude_cache, device_index: int) -> int:
        """Device memory already held by OTHER resident rooms' plans on the
        busiest card (:meth:`plan_bytes`), since admission checks a sharded
        plan against the cap card by card."""
        return max(self.plan_bytes(exclude_cache, device_index).values(),
                   default=0)

    def _budget_cfg(self, cache, device_index: int):
        """Per-call cfg whose plan caps subtract the memory other resident
        rooms' plans already hold on the device.

        Plan admission budgets each room against a PER-PLAN cap; with
        ``max_rooms > 1`` the sum of admitted plans could exceed the card.
        Serving owns the resident set, so it lowers each room's cap to what
        is left and admission demotes later rooms on its own ladder.
        """
        if self._max_rooms <= 1:
            return self.cfg
        other = self._resident_plan_bytes(cache, device_index)
        if not other:
            return self.cfg
        from .kernels.slab_sampling import default_plan_bytes_cap

        base = cfg_get(self.cfg, "slab_bytes_cap")
        if base is None:
            base = default_plan_bytes_cap(cache["device"])
        hist_base = cfg_get(self.cfg, "hist_planes_bytes_cap")
        overrides = dict(
            self.cfg._asdict(),
            slab_bytes_cap=max(0, int(base) - other),
            hist_planes_bytes_cap=max(
                0, int(hist_base if hist_base is not None else base) - other),
        )
        return make_config(**overrides)

    def _compute_room(self, prep, cache, device_index: int) -> Dict:
        """One full fused query against a room: the device work and ONE
        packed copy of the result to the host, under the compute lock; the
        reply carries the stages' ``route``."""
        img_init, img_main, rgb_used, prep_timed = prep
        with self._holding(device_index), profiling.span("service.solve"):
            t0 = time.time()
            # plans build in line: warming exists to take this cost at load
            res, route = _run_fused(
                img_init, img_main, cache, rgb_used,
                self._budget_cfg(cache, device_index), self.init_dict,
                cache["grids"], self.mesh, sync_plans=True,
            )
            with profiling.span("service.fetch"):
                packed = torch.cat([
                    res.t, res.rot.reshape(-1), res.loss.reshape(1),
                    res.winner.reshape(1).to(torch.float32), res.cand_loss,
                ]).cpu().numpy()
            elapsed = time.time() - t0 + prep_timed
        return dict(
            t=packed[:3], rot=packed[3:12].reshape(3, 3),
            loss=float(packed[12]), winner=int(packed[13]),
            cand_loss=packed[14:], time_s=elapsed, route=route,
        )

    @staticmethod
    def _parse_prev_pose(prev_pose):
        if isinstance(prev_pose, dict):
            t, ypr = prev_pose.get("t"), prev_pose.get("ypr")
        else:
            t, ypr = prev_pose  # (t, ypr) pair
        t = np.asarray(t, np.float32).reshape(3)
        ypr = np.asarray(ypr, np.float32).reshape(3)
        if not (np.isfinite(t).all() and np.isfinite(ypr).all()):
            raise ValueError(f"non-finite prev_pose: t={t} ypr={ypr}")
        return t, ypr

    def _track_kw(self, cache=None) -> Dict:
        """The tracking keys of the config, on ``cache``'s device (default:
        the first query device)."""
        from .tracking import track_kwargs

        dev = self.device if cache is None else cache["device"]
        return dict(device=dev, **track_kwargs(self.cfg))

    def _track_room(self, prep, cache, device_index: int, prev_pose) -> Dict:
        """One warm-started single-start descent (``tracking.track_step``)
        instead of the full pipeline; the same lock and one-copy discipline
        as :meth:`_compute_room`."""
        from .tracking import track_step_fetched

        _, img_main, rgb_used, prep_timed = prep
        t_prev, ypr_prev = self._parse_prev_pose(prev_pose)
        with self._holding(device_index), profiling.span("service.solve"):
            t0 = time.time()
            with profiling.span("track.upload"):
                img = as_tensor(img_main, cache["device"], torch.float32)
            t, ypr, rot, loss = track_step_fetched(
                img, cache["xyz"], rgb_used, t_prev, ypr_prev,
                cache["lo"], cache["hi"], cache["mask"],
                **self._track_kw(cache))
            elapsed = time.time() - t0 + prep_timed
        return dict(t=t, rot=rot, loss=loss, winner=0,
                    cand_loss=np.asarray([loss], np.float32), ypr=ypr,
                    time_s=elapsed, tracked=True)

    def _track_room_maybe_batched(self, prep, cache, device_index: int,
                                  prev_pose) -> Dict:
        """``track_batch = True``: tracked requests waiting on the same
        device for the same room and frame shape are drained as ONE batch
        (``tracking.track_steps_batched``: one K-start descent, one graph on
        the card) by whichever request next takes the compute lock.

        A batch forms only from requests already queued, so serial traffic
        runs the single-stream path with no added latency.  Batches pad up
        to a power of two (repeating the last stream), so concurrent load
        meets a handful of descent shapes, not one per K.  A request whose
        colours were rebound (``sharpen_color``) runs alone: its cloud
        colours are its own, and the batch shares the room's."""
        _, img_main, rgb_used, prep_timed = prep
        if (not cfg_get(self.cfg, "track_batch", False)
                or rgb_used is not cache["rgb"]):
            return self._track_room(prep, cache, device_index, prev_pose)
        t_prev, ypr_prev = self._parse_prev_pose(prev_pose)
        entry = dict(img=img_main, t=t_prev, ypr=ypr_prev,
                     prep_timed=prep_timed,
                     key=(id(cache), tuple(img_main.shape)),
                     event=threading.Event(), out=None,
                     requests=profiling.current_requests())
        qlock = self._track_qlocks[device_index]
        queue = self._track_queues[device_index]
        with qlock:
            entry["queued_ns"] = time.time_ns()
            queue.append(entry)
        with self._holding(device_index):
            if not entry["event"].is_set():
                with qlock:
                    # drain by identity: entries hold arrays, on which
                    # deque.remove's == is ambiguous
                    max_batch = max(
                        1, int(cfg_get(self.cfg, "track_max_batch", 8)))
                    batch, keep = [entry], []
                    for e in queue:
                        if e is entry:
                            continue
                        if (e["key"] == entry["key"]
                                and len(batch) < max_batch):
                            batch.append(e)
                        else:
                            keep.append(e)
                    queue.clear()
                    queue.extend(keep)
                self._run_track_batch(batch, cache)
        out = entry["out"]
        if isinstance(out, BaseException):
            raise out
        return out

    def _run_track_batch(self, batch, cache) -> None:
        """Run one drained batch of tracked requests (compute lock held)
        and hand each request its answer, with ``"batched": K`` when
        K > 1.  While tracing, the batch is a ``track.batch`` span over its
        requests' ids, and each request's wait from its queueing to the
        batch's start a ``track.queue_wait`` record."""
        from .tracking import track_step_fetched, track_steps_batched

        bucket = 1
        while bucket < len(batch):
            bucket *= 2
        try:
            t0 = time.time()
            with profiling.span(
                    "track.batch", k=len(batch), bucket=bucket,
                    requests=tuple(r for e in batch for r in e["requests"])):
                start = time.time_ns()
                for e in batch:
                    profiling.record("track.queue_wait", e["queued_ns"],
                                     start, requests=e["requests"])
                kw = self._track_kw(cache)
                dev = cache["device"]
                if len(batch) == 1:
                    e = batch[0]
                    with profiling.span("track.upload"):
                        img = as_tensor(e["img"], dev, torch.float32)
                    results = [track_step_fetched(
                        img, cache["xyz"], cache["rgb"], e["t"], e["ypr"],
                        cache["lo"], cache["hi"], cache["mask"], **kw)]
                else:
                    rows = batch + [batch[-1]] * (bucket - len(batch))
                    with profiling.span("track.upload"):
                        imgs = torch.stack([as_tensor(e["img"], dev,
                                                      torch.float32)
                                            for e in rows])
                    results = track_steps_batched(
                        imgs, cache["xyz"], cache["rgb"],
                        np.stack([e["t"] for e in rows]),
                        np.stack([e["ypr"] for e in rows]),
                        cache["lo"], cache["hi"], cache["mask"], **kw,
                    )[: len(batch)]
            elapsed = time.time() - t0
            extra = {"batched": len(batch)} if len(batch) > 1 else {}
            for e, (t, ypr, rot, loss) in zip(batch, results):
                e["out"] = dict(t=t, rot=rot, loss=loss, winner=0,
                                cand_loss=np.asarray([loss], np.float32),
                                ypr=ypr, time_s=elapsed + e["prep_timed"],
                                tracked=True, **extra)
        except BaseException as exc:
            for e in batch:
                e["out"] = exc
            raise
        finally:
            for e in batch:
                e["event"].set()

    def _probe_room(self, prep, cache, device_index: int) -> float:
        """The per-room ranking probe of room='auto': stages 1 and 2, then
        a short pruned descent at the init resolution
        (``harness.localize._run_fused(probe=True)``); the winner loss."""
        img_init, img_main, rgb_used, _ = prep
        with self._holding(device_index):
            res, _ = _run_fused(
                img_init, img_main, cache, rgb_used,
                self._budget_cfg(cache, device_index), self.init_dict,
                cache["grids"], self.mesh, sync_plans=True, probe=True,
            )
            return float(res.loss)

    def _probe_state_batched(self, device_index: int):
        """The batched probe's tensors for the current resident set
        (``probe.build_probe_state``), rebuilt when the set changes."""
        from .probe import build_probe_state

        with self._rooms_lock:
            rooms = [(n, r[device_index]) for n, r in self._rooms.items()]
        key = tuple((n, id(c)) for n, c in rooms)
        held = self._batched_probes.get(device_index)
        if held is None or held[0] != key:
            # the rotation grid is config-derived, identical across rooms
            st = build_probe_state(
                rooms, rooms[0][1]["grids"].rot,
                max_pairs=int(cfg_get(self.cfg, "room_auto_probe_pairs",
                                      512)),
                device=self._devices[device_index])
            held = self._batched_probes[device_index] = (key, st)
        return held[1]

    def _probe_kwargs(self) -> Dict:
        return dict(
            num_starts=int(cfg_get(self.cfg, "room_auto_probe_starts", 6)),
            num_iter=int(cfg_get(self.cfg, "room_auto_probe_iters", 30)),
            lr=cfg_get(self.cfg, "lr", 0.1),
            patience=cfg_get(self.cfg, "patience", 5),
            factor=cfg_get(self.cfg, "factor", 0.8),
            wrap=bool(cfg_get(self.cfg, "seam_wrap", False)),
        )

    def _batched_probe_usable(self, n_rooms: int) -> bool:
        """The batched probe shares ONE prepared init image across rooms,
        so per-room colour prep (``match_color`` / ``sharpen_color`` rebind
        against each room's cloud) rules it out: the per-room probe runs
        instead, with a one-time warning."""
        if n_rooms < 2:
            return False
        if (cfg_get(self.cfg, "match_color", False)
                or cfg_get(self.cfg, "sharpen_color", False)):
            if not getattr(self, "_warned_batched_color", False):
                self._warned_batched_color = True
                warnings.warn(
                    "room_auto_probe='batched' needs a room-independent "
                    "init image; match_color/sharpen_color rebind colours "
                    "per room — falling back to the per-room probe")
            return False
        return True

    def _select_room(self, img: np.ndarray, device_index: int):
        """room='auto': pick the resident room whose localization loss is
        lowest.

        Default: one FULL query per resident room; the lowest finite winner
        loss answers.  A descended loss is the discriminator because a
        stage-1 grid minimum does not separate rooms made by one generator.

        ``room_auto_probe = True``: a truncated per-room probe
        (:meth:`_probe_room`) ranks the rooms; only rooms whose probe loss
        is within ``room_auto_margin`` (default 3x) of the best run the full
        query (the full loop over every room when no probe loss is
        finite).  ``room_auto_probe = "batched"``: ONE probe scores every
        resident room (``probe.probe_rooms``: a truncated loss table per
        room, then one descent of every room's starts, one (R,) copy) on a
        per-room pair budget (``room_auto_probe_pairs``), and the finalists
        follow as above.  It shares one prepared image across rooms, so
        under ``match_color`` / ``sharpen_color`` the per-room probe runs
        instead (:meth:`_batched_probe_usable`).
        """
        with self._rooms_lock:
            candidates = [(name, replicas[device_index])
                          for name, replicas in self._rooms.items()]
        scores: Dict[str, float] = {}
        preps: Dict[str, tuple] = {}
        # one-ahead prep: room k+1's host prep runs on a thread while room
        # k holds the device
        next_prep = [self._prepare(img, candidates[0][1])]

        def _prep_into(cache):
            next_prep[0] = self._prepare(img, cache)

        probe_cfg = cfg_get(self.cfg, "room_auto_probe", False)
        probe = bool(probe_cfg) and len(candidates) > 1
        batched = (probe and probe_cfg == "batched"
                   and self._batched_probe_usable(len(candidates)))
        order, cut = candidates, None
        if batched:
            st = self._probe_state_batched(device_index)
            prep0 = next_prep[0]
            with self._holding(device_index):
                losses = st.losses(prep0[0], **self._probe_kwargs())
            # the images are room-independent here, but rgb_used must be
            # each room's own colours (identity with cache["rgb"] admits the
            # room's baked plans in _run_fused)
            for name, cache in candidates:
                preps[name] = (prep0[0], prep0[1], cache["rgb"], prep0[3])
            scores.update(zip(st.names, (float(v) for v in losses)))
            for name, _ in candidates:
                # a load or eviction between the snapshot and the state's
                # rebuild leaves a candidate unscored: a non-finalist
                scores.setdefault(name, float("inf"))
        elif probe:
            for i, (name, cache) in enumerate(candidates):
                prep = preps[name] = next_prep[0]
                th = None
                if i + 1 < len(candidates):
                    th = threading.Thread(
                        target=contextvars.copy_context().run,
                        args=(_prep_into, candidates[i + 1][1]))
                    th.start()
                scores[name] = self._probe_room(prep, cache, device_index)
                if th is not None:
                    th.join()
        if probe:
            finite = [s for s in scores.values() if np.isfinite(s)]
            if finite:
                margin = float(cfg_get(self.cfg, "room_auto_margin", 3.0))
                cut = min(finite) * margin
                # finalists by probe rank; the others follow as the
                # fallback chain for a finalist whose full query degenerates
                order = sorted(
                    candidates,
                    key=lambda nc: (
                        not (np.isfinite(scores[nc[0]])
                             and scores[nc[0]] <= cut),
                        scores[nc[0]],
                    ),
                )

        best = None
        for i, (name, cache) in enumerate(order):
            if (cut is not None and best is not None
                    and np.isfinite(best[1]["loss"])
                    and not (np.isfinite(scores.get(name, np.inf))
                             and scores[name] <= cut)):
                break  # finalists exhausted with a finite answer
            prep = preps.get(name)
            th = None
            if prep is None:
                prep = preps[name] = next_prep[0]
                if i + 1 < len(order):
                    th = threading.Thread(
                        target=contextvars.copy_context().run,
                        args=(_prep_into, order[i + 1][1]))
                    th.start()
            fields = self._compute_room(prep, cache, device_index)
            if th is not None:
                th.join()
            scores[name] = fields["loss"]
            # non-finite losses (all-masked renders) never win nor block a
            # later finite room from winning
            if best is None or (
                np.isfinite(fields["loss"])
                and not (np.isfinite(best[1]["loss"])
                         and best[1]["loss"] <= fields["loss"])
            ):
                best = (name, fields)
        if not np.isfinite(best[1]["loss"]):
            raise ValueError(
                "room='auto' found no finite localization loss in any "
                "resident room (all-black/empty query image?)"
            )
        with self._rooms_lock:
            if best[0] in self._rooms:
                self._rooms.move_to_end(best[0])
        return best[0], best[1], scores

    def _localize_admitted(self, img: np.ndarray, room: Optional[str],
                           device_index: Optional[int] = None, prev_pose=None,
                           recover_above: Optional[float] = None) -> Dict:
        t_start = time.time()
        if device_index is None:  # the query devices in turn
            with self._rr_lock:
                device_index = self._rr % len(self._devices)
                self._rr += 1
        # the request's card is the thread's current device, so that work
        # which takes the current device (streams, events, a bare "cuda")
        # lands on the replica's card and not on cuda:0
        dev = self._devices[device_index]
        with profiling.request(
                "service.request", device=device_index,
                kind="query" if prev_pose is None else "tracked"), (
                torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext()):
            return self._localize_on(img, room, device_index, t_start,
                                     prev_pose, recover_above)

    def _localize_on(self, img: np.ndarray, room: Optional[str],
                     device_index: int, t_start: float, prev_pose,
                     recover_above: Optional[float]) -> Dict:
        room_scores = None
        if room == "auto":
            if prev_pose is not None:
                raise ValueError(
                    'room="auto" runs the full pipeline per room and '
                    "cannot take prev_pose — name the room when tracking"
                )
            room, fields, room_scores = self._select_room(img, device_index)
        else:
            # the room resolves under the registry lock; the host prep runs
            # outside the compute lock, overlapping other requests' compute
            with self._rooms_lock:
                if room is None:
                    room = next(reversed(self._rooms))
                if room not in self._rooms:
                    raise KeyError(f"room {room!r} not resident "
                                   f"(have: {list(self._rooms)})")
                self._rooms.move_to_end(room)
                cache = self._rooms[room][device_index]
            prep = self._prepare(img, cache)
            if prev_pose is not None:
                fields = self._track_room_maybe_batched(
                    prep, cache, device_index, prev_pose)
                if recover_above is not None and not (
                    np.isfinite(fields["loss"])
                    and fields["loss"] <= float(recover_above)
                ):
                    # tracking lost: the SAME request falls back to the full
                    # pipeline, and the client continues from its pose
                    from .tracking import ypr_from_rot

                    fields = dict(
                        self._compute_room(prep, cache, device_index),
                        tracked=True, recovered=True)
                    fields["ypr"] = ypr_from_rot(fields["rot"])
            else:
                fields = self._compute_room(prep, cache, device_index)
        out = dict(**fields, total_s=time.time() - t_start, room=room,
                   device_index=device_index)
        if room_scores is not None:
            out["room_scores"] = room_scores
        return out


# -- HTTP front ------------------------------------------------------------


_LOOPBACK_HOSTS = {"127.0.0.1", "localhost", "::1"}


def _resolve_payload_path(path: str, data_root: Optional[str],
                          paths_allowed: bool) -> str:
    """Validate a filesystem path arriving in a request payload.

    Trust model: on the default loopback bind every local process that can
    reach the socket already has this process's filesystem access, so any
    path is fine.  On a non-loopback bind the HTTP surface is
    unauthenticated, so path payloads are refused unless ``data_root``
    confines them (realpath + prefix check, symlink-safe).
    """
    if not paths_allowed:
        raise ValueError(
            "path-based payloads are disabled on non-loopback binds; "
            "start the server with --data-root or send image_b64"
        )
    if data_root is None:
        return path
    import os

    real = os.path.realpath(path)
    root = os.path.realpath(data_root)
    if not (real == root or real.startswith(root + os.sep)):
        raise ValueError(
            f"path {path!r} resolves outside the configured data root")
    return real


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8"


def _decode_image(payload: Dict, data_root: Optional[str] = None,
                  paths_allowed: bool = True) -> np.ndarray:
    """The request's panorama as (H, W, 3) uint8 RGB: ``image_path`` read
    by the harness's ``imread_rgb``, or ``image_b64`` decoded by the port's
    own PNG or JPEG decoder, chosen by the magic bytes."""
    from .harness.imaging import imread_rgb, jpeg_decode, png_decode

    if "image_path" in payload:
        return imread_rgb(_resolve_payload_path(
            payload["image_path"], data_root, paths_allowed))
    if "image_b64" in payload:
        raw = base64.b64decode(payload["image_b64"])
        if raw.startswith(_PNG_MAGIC):
            img = png_decode(raw)
        elif raw.startswith(_JPEG_MAGIC):
            img = jpeg_decode(raw)
        else:
            raise ValueError("image_b64 is neither a PNG nor a JPEG")
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        return img
    raise ValueError("payload needs image_path or image_b64")


def serve_forever(service: LocalizeService, host: str = "127.0.0.1",
                  port: int = 8321, ready_event=None,
                  data_root: Optional[str] = None):
    """Blocking HTTP server over ``service`` (stdlib, JSON API).

    Endpoints: ``GET /healthz`` (with the plan bytes each card holds);
    ``POST /localize`` with
    ``{"image_path" | "image_b64": ..., "room", "prev_pose",
    "recover_above"}``; ``POST /room`` with ``{"pcd_path": ...}``.  Errors
    answer 400 (bad request), 404 (unknown path), 503 with Retry-After
    (beyond ``max_pending``) or 500.  ``ready_event`` (a
    ``threading.Event``) gets the server as ``ready_event.server`` and is
    set once the socket listens.  Path payloads follow
    :func:`_resolve_payload_path`'s trust model.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    paths_allowed = host in _LOOPBACK_HOSTS or data_root is not None

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: Dict, headers=None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            try:
                if self.path == "/healthz":
                    # busy/pending are the backpressure signal
                    self._reply(200, {
                        "ok": True, "room": service.room,
                        "rooms": service.rooms, "busy": service.busy,
                        "devices": service.devices,
                        "busy_devices": service.busy_devices,
                        "pending": service.pending,
                        "max_pending": service.max_pending,
                        "plan_bytes": service.plan_bytes()})
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as exc:  # health probes see no tracebacks
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/localize":
                    out = service.localize(
                        _decode_image(payload, data_root, paths_allowed),
                        room=payload.get("room"),
                        prev_pose=payload.get("prev_pose"),
                        recover_above=payload.get("recover_above"),
                    )
                    reply = {
                        "t": out["t"].tolist(),
                        "rot": out["rot"].tolist(),
                        # a non-finite loss would make json.dumps emit bare
                        # NaN/Infinity, which is not RFC 8259 JSON
                        "loss": (out["loss"]
                                 if np.isfinite(out["loss"]) else None),
                        "winner": out["winner"],
                        "time_s": out["time_s"],
                        "total_s": out["total_s"],
                        "room": out["room"],
                        "device_index": out["device_index"],
                    }
                    if "route" in out:
                        reply["route"] = out["route"]
                    if out.get("tracked"):
                        reply["tracked"] = True
                        reply["recovered"] = bool(out.get("recovered"))
                        if "ypr" in out:
                            reply["ypr"] = np.asarray(out["ypr"]).tolist()
                    if "room_scores" in out:
                        reply["room_scores"] = {
                            k: (v if np.isfinite(v) else None)
                            for k, v in out["room_scores"].items()}
                    self._reply(200, reply)
                elif self.path == "/room":
                    service.load_room_pcd(
                        _resolve_payload_path(payload["pcd_path"], data_root,
                                              paths_allowed),
                        payload.get("dataset"))
                    self._reply(200, {"ok": True, "room": service.room})
                else:
                    self._reply(404, {"error": "unknown path"})
            # served errors never kill the process, and bad requests (4xx)
            # stay apart from a broken server (5xx: RuntimeError, which
            # device errors and "no room loaded" raise)
            except ServiceOverloaded as exc:
                self._reply(503, {"error": f"ServiceOverloaded: {exc}"},
                            headers={"Retry-After": "1"})
            except (ValueError, KeyError, json.JSONDecodeError,
                    FileNotFoundError) as exc:
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            except Exception as exc:
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

        def log_message(self, *a):  # quiet
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    if ready_event is not None:
        ready_event.server = server
        ready_event.set()
    server.serve_forever()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="piccolo_tpu_torch localization service (HTTP JSON API)")
    ap.add_argument("--config", required=True, help="ini config (harness keys)")
    ap.add_argument("--pcd", action="append", default=[],
                    help="room point cloud(s) to preload (repeatable)")
    ap.add_argument("--max-rooms", type=int, default=4,
                    help="resident-room LRU size")
    ap.add_argument("--max-pending", type=int, default=8,
                    help="admission bound on in-flight requests; beyond it "
                         "requests get 503 + Retry-After")
    ap.add_argument("--warm", metavar="HxW",
                    help="pre-warm every preloaded room at this panorama "
                         "shape (e.g. 512x1024): plans build and kernels "
                         "load before the first real query")
    ap.add_argument("--exec-cache", metavar="DIR",
                    help="executable-cache directory: a restart loads the "
                         "built kernel libraries and JPEG codec instead of "
                         "compiling them (utils/exec_cache.py).  Shorthand "
                         "for --override exec_cache_dir=DIR")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--data-root",
                    help="confine image_path/pcd_path payloads to this "
                         "directory (required for path payloads on a "
                         "non-loopback --host)")
    ap.add_argument("--override", type=str, default=None,
                    help="config overrides, e.g. 'descent_table=float32' "
                         "(the batch CLI's grammar)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="serve on the card (default) or on the CPU")
    return ap


def main(argv=None) -> None:
    from .config import apply_overrides
    from .utils import enable_compilation_cache

    args = build_parser().parse_args(argv)
    enable_compilation_cache()
    cfg = apply_overrides(parse_ini(args.config), args.override)
    if args.exec_cache:
        cfg = apply_overrides(cfg, f"exec_cache_dir={args.exec_cache}")
    svc = LocalizeService(cfg, max_rooms=args.max_rooms,
                          max_pending=args.max_pending, device=args.device)
    if svc.exec_cache is not None:
        from .utils import exec_cache

        print(exec_cache.describe(svc.exec_cache), flush=True)
    for pcd in args.pcd:
        svc.load_room_pcd(pcd)
    if args.warm:
        H, W = (int(v) for v in args.warm.lower().split("x"))
        noise = np.random.default_rng(0).integers(0, 256, (H, W, 3),
                                                  dtype=np.uint8)
        for name in svc.rooms:
            t0 = time.time()
            for di in range(svc.devices):  # every query device
                svc._localize_checked(noise, room=name, device_index=di)
            print(f"warmed {name} at {H}x{W} in {time.time() - t0:.1f}s",
                  flush=True)
    print(f"serving on {args.host}:{args.port} (room: {svc.room})",
          flush=True)
    serve_forever(svc, args.host, args.port, data_root=args.data_root)


if __name__ == "__main__":
    main()
