"""The port's plan admission ladder and plan lifecycle
(``harness/localize.py``: ``_slab_admission``, ``_maybe_slab_plan``,
``_maybe_hist_plan``, ``_run_fused``) on the CPU.

  * Admission decisions equal the JAX package's, layout by layout (f32,
    compact, q8, partial q8, refused), with and without the sharpen
    re-bake copy; ``slab_worthwhile`` equals the JAX cost model.
  * On a CUDA device (a ``torch.device("cuda")`` object, no card needed)
    the routing values are the H100's: the cost model admits the plan at
    every shape the repo runs, the plan geometry, the descent table and
    the plan budget follow the card's values, a card room under
    sharpen_color admits the f32 plan, and the gather engine's chunk rule
    keeps every score's bits.
  * The lifecycle: plans build in line by default with no disk cache; the
    background build hands its plan to a later query; an f32 plan over
    budget demotes to compact once; a compact plan over budget is retried
    with a tight block count; a failed build marks the room; a partial plan
    routes its tail to the gather engine; an explicit disk cache persists
    and loads.

``auto`` plans are off on the CPU (the JAX package's CPU rule), so the
tests that need ``auto`` lift that rule, as the JAX package's own tests
lift its backend check.
"""

import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import piccolo_tpu.harness.localize as jhl
import piccolo_tpu.kernels.slab_sampling as jsm
import piccolo_tpu_torch.harness.localize as hl
import piccolo_tpu_torch.kernels.slab_sampling as sm
from piccolo_tpu.config import make_config as jmake_config
from piccolo_tpu_torch.config import make_config
from piccolo_tpu_torch.kernels import plan_cache as pc
from piccolo_tpu_torch.testing import make_room, render_at

torch.set_num_threads(2)

N_T, R = 128, 4  # 512 pairs: four 128-pair groups


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    xyz, rgb = make_room(rng, n_per_wall=128, size=(4.0, 3.0, 2.5))
    img_main = render_at(xyz, rgb, np.array([0.3, -0.2, 0.0], np.float32),
                         np.array([0.7, 0.0, 0.0], np.float32), (64, 128),
                         device="cpu").numpy()
    trans = rng.uniform(-1.2, 1.2, (N_T, 3)).astype(np.float32)
    trans[:, 2] = 0.0
    rot = np.stack([np.linspace(0, 2 * np.pi, R, endpoint=False),
                    np.zeros(R), np.zeros(R)], 1).astype(np.float32)
    return dict(xyz=xyz, rgb=rgb, img_main=img_main,
                img=img_main[::2, ::2].copy(), trans=trans, rot=rot)


def _room(s, n_t=N_T):
    """The port's per-room state and candidate grids, as localize_stanford
    builds them (on the CPU)."""
    xyz_d, rgb_d, mask_d = hl._pad_cloud(s["xyz"], s["rgb"], "cpu")
    lo, hi = hl._order_bounds(s["xyz"], 0.05)
    cache = dict(xyz=xyz_d, rgb=rgb_d, mask=mask_d, lo=lo, hi=hi,
                 device=torch.device("cpu"))
    grids = types.SimpleNamespace(
        trans=torch.tensor(s["trans"][:n_t]), rot=torch.tensor(s["rot"]),
        valid=torch.ones(n_t, dtype=torch.bool), n_trans=n_t)
    return cache, grids


def _cfg(**kw):
    return make_config(dataset="Stanford2D-3D-S", **kw)


@pytest.fixture
def on_card(monkeypatch):
    """Lift the CPU rule, so ``auto`` admits plans as on the card."""
    monkeypatch.setattr(hl, "_auto_plans_off", lambda device: False)


def _pending(cache):
    return [k for k in cache if isinstance(k, tuple)
            and k[0] in ("slab_plan_pending", "hist_plan_pending")]


def _join_pending(cache):
    for k in _pending(cache):
        cache[k]["thread"].join(timeout=120)
        assert not cache[k]["thread"].is_alive()


def _estimates(n_points):
    n_pairs = N_T * R
    return dict(f32=sm.plan_bytes_estimate(n_pairs, n_points),
                compact=sm.plan_bytes_estimate(n_pairs, n_points, compact=True),
                q8=sm.plan_bytes_estimate(n_pairs, n_points, quant=True))


# ---------------------------------------------------------------------------
# admission: the same decisions as the JAX package


CASES = {  # cap as (layout estimate, factor), or a forced mode
    "f32": ("f32", 1.01),
    "compact": ("compact", 1.01),
    "q8": ("q8", 1.01),
    "partial": ("q8", 0.6),
    "refused": ("q8", 1 / 16),
    "forced q8": None,
}


@pytest.mark.parametrize("sharpen", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_admission_matches_jax(scene, monkeypatch, on_card, case, sharpen):
    cache, grids = _room(scene)
    n_points = int(cache["mask"].shape[0])
    copy = {"f32": 2.0, "compact": 1.25, "q8": 1.5}
    if CASES[case] is None:
        kw = dict(slab_init=True, slab_quant=True)
    else:
        layout, factor = CASES[case]
        m = copy[layout] if sharpen else 1.0
        kw = dict(slab_init="auto",
                  slab_bytes_cap=int(_estimates(n_points)[layout] * m * factor))
    monkeypatch.setattr(sm, "slab_worthwhile", lambda *a, **k: True)
    monkeypatch.setattr(jsm, "slab_worthwhile", lambda *a, **k: True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    got = hl._slab_admission_uncached(_cfg(sharpen_color=sharpen, **kw), cache,
                                      grids, scene["img"])
    jcache = dict(mask=jnp.ones(n_points, bool))
    want = jhl._slab_admission_uncached(
        jmake_config(dataset="Stanford2D-3D-S", sharpen_color=sharpen, **kw),
        jcache, grids, scene["img"])
    assert got == want
    expect = {"f32": (False, False), "compact": (True, False),
              "q8": (True, True), "partial": (True, True),
              "forced q8": (True, True)}
    if case == "refused":
        assert got is None
    else:
        assert (got["compact"], got["quant"]) == expect[case]
        partial = got["n_t_build"] < got["n_t"]
        assert partial == (case == "partial")
        if partial:  # a whole number of trans rows, 2 of the 4 groups
            assert got["n_t_build"] == 2 * sm.GROUP // R


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_slab_worthwhile_matches_jax(refresh, compact):
    for n_pairs in (128, 1080, 20000):
        for n_points in (4096, 65536, 10**6):
            for h, w in ((256, 512), (512, 1024), (1024, 2048)):
                args = (n_pairs, n_points, h, w)
                assert sm.slab_worthwhile(*args, refresh=refresh,
                                          compact=compact) == \
                    jsm.slab_worthwhile(*args, refresh=refresh,
                                        compact=compact), args


def test_admission_memoized_per_room(scene, monkeypatch):
    cache, grids = _room(scene)
    calls = []
    real = hl._slab_admission_uncached

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(hl, "_slab_admission_uncached", counting)
    hl._slab_admission(_cfg(slab_init="auto"), cache, grids, scene["img"])
    hl._slab_admission(_cfg(slab_init="auto"), cache, grids, scene["img"])
    assert len(calls) == 1
    hl._slab_admission(_cfg(slab_init="auto", slab_bytes_cap=12345), cache,
                       grids, scene["img"])
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# the lifecycle


def test_default_lifecycle_builds_in_line_without_disk_cache(
        scene, monkeypatch, tmp_path):
    """With no lifecycle keys, the slab plan and the HistPlan build in the
    query that needs them, no thread starts and nothing is written."""
    monkeypatch.setattr(pc, "default_plan_cache_dir", lambda: str(tmp_path))
    cache, grids = _room(scene, n_t=3)
    cfg = _cfg(slab_init=True, hist_planes=True)
    before = set(threading.enumerate())
    plan = hl._maybe_slab_plan(cfg, cache, grids, scene["img"])
    hist = hl._maybe_hist_plan(cfg, cache, grids, scene["img"])
    assert plan is not None and not plan.compact and plan.n_pairs == 3 * R
    assert hist is not None
    assert not _pending(cache)
    assert set(threading.enumerate()) <= before
    assert os.listdir(tmp_path) == []
    assert hl._maybe_slab_plan(cfg, cache, grids, scene["img"]) is plan


def test_background_build_hands_off(scene):
    cache, grids = _room(scene, n_t=3)
    cfg = _cfg(slab_init=True, slab_background_build=True)
    assert hl._maybe_slab_plan(cfg, cache, grids, scene["img"]) is None
    assert len(_pending(cache)) == 1
    _join_pending(cache)
    plan = hl._maybe_slab_plan(cfg, cache, grids, scene["img"])
    direct = sm.build_grid_plan(cache["xyz"], cache["rgb"], cache["mask"],
                                grids.trans, grids.rot, 32, 64, device="cpu")
    img = torch.tensor(scene["img"])
    assert torch.equal(sm.slab_pair_scores(img, plan),
                       sm.slab_pair_scores(img, direct))
    # sync=True (a warm-up) builds in line whatever the key says
    cache2, _ = _room(scene, n_t=3)
    assert hl._maybe_slab_plan(cfg, cache2, grids, scene["img"],
                               sync=True) is not None


@pytest.mark.parametrize("background", [False, True])
def test_tight_nb_retry_on_bucket_padding(scene, monkeypatch, on_card,
                                          background):
    """f32 over budget demotes to compact; compact over budget with the
    bucketed block count is retried once with a tight one (1100 raw blocks
    -> 1280, under the 1536 bucket)."""
    calls = []
    real_build = sm.build_grid_plan

    def fake_build(*a, nb=None, bytes_cap=None, **k):
        calls.append(nb)
        if nb is None:
            raise sm.PlanOverBudget(100, 50)
        return real_build(*a, nb=nb, **k)

    monkeypatch.setattr(sm, "build_grid_plan", fake_build)
    monkeypatch.setattr(sm, "plan_required_blocks", lambda *a, **k: 1100)
    monkeypatch.setattr(sm, "slab_worthwhile", lambda *a, **k: True)
    cache, grids = _room(scene, n_t=3)
    cfg = _cfg(slab_init="auto", slab_bytes_cap=10**12,
               slab_background_build=background)
    plan = None
    for _ in range(3 if background else 1):
        plan = hl._maybe_slab_plan(cfg, cache, grids, scene["img"])
        _join_pending(cache)
    assert plan is not None and plan.compact and not plan.quant
    assert plan.fields[0].shape[0] == 1280
    assert calls == [None, None, 1280], calls


def test_background_f32_over_budget_demotes_once(scene, monkeypatch, on_card):
    builds = []
    real_build = sm.build_grid_plan

    def fake_build(*a, compact=False, bytes_cap=None, nb=None, **k):
        builds.append("compact" if compact else "f32")
        if not compact:
            raise sm.PlanOverBudget(100, 50)
        return real_build(*a, compact=compact, nb=nb, **k)

    monkeypatch.setattr(sm, "build_grid_plan", fake_build)
    monkeypatch.setattr(sm, "slab_worthwhile", lambda *a, **k: True)
    cache, grids = _room(scene, n_t=3)
    cfg = _cfg(slab_init="auto", slab_bytes_cap=10**12,
               slab_background_build=True)
    img = scene["img"]
    assert hl._maybe_slab_plan(cfg, cache, grids, img) is None  # f32 spawned
    _join_pending(cache)
    assert hl._maybe_slab_plan(cfg, cache, grids, img) is None  # compact
    _join_pending(cache)
    plan = hl._maybe_slab_plan(cfg, cache, grids, img)
    assert plan is not None and plan.compact
    assert hl._maybe_slab_plan(cfg, cache, grids, img) is plan
    assert builds == ["f32", "compact"]


@pytest.mark.parametrize("background", [False, True])
def test_failed_build_marks_the_room(scene, monkeypatch, background):
    """A build failure that is not over budget demotes the room to the
    gather engine for both layouts and is not retried."""
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("out of memory")

    monkeypatch.setattr(sm, "build_grid_plan", boom)
    cache, grids = _room(scene, n_t=3)
    cfg = _cfg(slab_init=True, slab_background_build=background)
    for _ in range(3):
        assert hl._maybe_slab_plan(cfg, cache, grids, scene["img"]) is None
        _join_pending(cache)
    assert len(calls) == 1
    failed = sorted(k[3] for k in cache
                    if isinstance(k, tuple) and k[0] == "slab_plan_failed")
    assert failed == [False, True]
    hl._drop_slab_plans(cache)
    assert not [k for k in cache if isinstance(k, tuple)]


def test_partial_q8_plan_routes_its_tail_to_the_gather_engine(
        scene, monkeypatch, on_card):
    """A cap under the q8 estimate builds the leading whole trans rows that
    fit as a q8 plan; the query scores the rest on the gather engine."""
    seen = {}
    real_build = sm.build_grid_plan

    def recording_build(xyz, rgb, mask, trans, rot, h, w, bytes_cap=None,
                        **k):
        seen.update(rows=int(trans.shape[0]), cap=bytes_cap, **k)
        return real_build(xyz, rgb, mask, trans, rot, h, w, **k)

    monkeypatch.setattr(sm, "build_grid_plan", recording_build)
    monkeypatch.setattr(sm, "slab_worthwhile", lambda *a, **k: True)
    cache, grids = _room(scene)
    cap = int(_estimates(int(cache["mask"].shape[0]))["q8"] * 0.6)
    kw = dict(slab_bytes_cap=cap, num_intermediate=8, num_input=4,
              num_iter=5, lr=0.01, patience=5, factor=0.8)
    init = dict(num_split_h=4, num_split_w=4)
    s = scene
    res, route = hl._run_fused(s["img"], s["img_main"], cache, cache["rgb"],
                               _cfg(slab_init="auto", **kw), init, grids)
    n_rows = 2 * sm.GROUP // R
    assert seen["rows"] == n_rows and seen["quant"] and seen["compact"]
    assert seen["cap"] == cap
    plan = cache[next(k for k in cache if isinstance(k, tuple)
                      and k[0] == "slab_plan")]
    assert plan.quant and plan.n_pairs == n_rows * R
    assert route == ("stage 1 q8 slab plan (partial) + gather engine tail, "
                     "stage 2 HistPlan planes")
    assert np.isfinite(res.t.numpy()).all() and res.t.shape == (3,)
    cache_g, _ = _room(s)
    _, route_g = hl._run_fused(s["img"], s["img_main"], cache_g,
                               cache_g["rgb"], _cfg(slab_init=False, **kw),
                               init, grids)
    assert route_g == "stage 1 gather engine, stage 2 HistPlan planes"


def test_explicit_disk_cache_persists_then_loads(scene, monkeypatch, tmp_path):
    cfg = _cfg(slab_init=True, slab_compact=True, slab_plan_cache=True,
               slab_plan_cache_dir=str(tmp_path))
    cache, grids = _room(scene, n_t=3)
    plan = hl._maybe_slab_plan(cfg, cache, grids, scene["img"])
    for t in threading.enumerate():
        if t.name == "piccolo-plan-save":
            t.join(timeout=60)
            assert not t.is_alive()
    assert [f for f in os.listdir(tmp_path) if f.endswith(".npz")]

    def boom(*a, **k):
        raise AssertionError("rebuilt despite a disk cache hit")

    monkeypatch.setattr(sm, "build_grid_plan", boom)
    cache2, grids2 = _room(scene, n_t=3)
    plan2 = hl._maybe_slab_plan(cfg, cache2, grids2, scene["img"])
    img = torch.tensor(scene["img"])
    assert torch.equal(sm.slab_pair_scores(img, plan),
                       sm.slab_pair_scores(img, plan2))


# ---------------------------------------------------------------------------
# the card's routing values (a torch.device("cuda") object needs no card)

CARD = torch.device("cuda")
H100_BYTES = 85_017_493_504  # an H100 80GB HBM3's mem_get_info total

# (pairs, points, init height, init width): stanford.ini's full grid, the
# CLI tree's (chip_smoke.py runs A and D), the library room, OmniScenes
# (2048x1024 init) and the 1.02 M-point stretch room
CARD_SHAPES = {
    "stanford.ini grid": (3200, 60000, 512, 1024),
    "stanford.ini CLI tree": (1080, 65536, 512, 1024),
    "library": (432, 65536, 256, 512),
    "omniscenes.ini": (1200, 65536, 1024, 2048),
    "stretch": (432, 1048576, 512, 1024),
}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_slab_worthwhile_admits_the_plan_on_the_card(shape, refresh,
                                                     compact):
    """On the card the plan beats the gather engine at every shape the repo
    runs, re-bake or not; the JAX package's model still refuses the
    stanford.ini grid under sharpen_color's re-bake off the card."""
    torch.set_num_threads(1)
    args = CARD_SHAPES[shape]
    assert sm.slab_worthwhile(*args, refresh=refresh, compact=compact,
                              device=CARD)
    if shape.startswith("stanford.ini") and refresh and not compact:
        assert not sm.slab_worthwhile(*args, refresh=refresh,
                                      compact=compact)
        assert not sm.slab_worthwhile(*args, refresh=refresh,
                                      compact=compact, device="cpu")


@pytest.mark.parametrize("table_hw", [(256, 512), (512, 1024), (1024, 2048),
                                      (2048, 4096)])
def test_slab_worthwhile_card_sweep(table_hw):
    """The measured sweep (6-403 MB tables): the plan wins from one group
    of pairs up to 20,000; a lone pair, which pays a whole 128-pair group,
    stays on the gather engine."""
    torch.set_num_threads(1)
    for n_pairs in (128, 1152, 4096, 20000):
        for refresh in (False, True):
            for compact in (False, True):
                assert sm.slab_worthwhile(n_pairs, 65536, *table_hw,
                                          refresh=refresh, compact=compact,
                                          device=CARD)
    assert not sm.slab_worthwhile(1, 65536, *table_hw, refresh=True,
                                  device=CARD)


@pytest.mark.parametrize("n_points,hw,card,jax_rule", [
    (65536, (256, 512), (128, 1024), (128, 1024)),   # library, density 0.50
    (65536, (512, 1024), (128, 1024), (256, 512)),   # CLI, 0.125
    (65536, (1024, 2048), (256, 512), (256, 512)),   # OmniScenes, 0.031
    (65536, (2048, 4096), (256, 512), (256, 512)),   # 403 MB, 0.0078
    (1048576, (512, 1024), (128, 1024), (128, 1024)),  # stretch, 2.0
])
def test_plan_geometry_on_the_card(n_points, hw, card, jax_rule):
    torch.set_num_threads(1)
    assert sm.resolve_plan_geometry(n_points, *hw, device=CARD) == card
    assert sm.resolve_plan_geometry(n_points, *hw) == jax_rule
    assert sm.resolve_plan_geometry(n_points, *hw, device="cpu") == jax_rule
    assert jsm.resolve_plan_geometry(n_points, *hw) == jax_rule
    # explicit values win on the card too
    assert sm.resolve_plan_geometry(n_points, *hw, window=512, block=256,
                                    device=CARD) == (512, 256)


@pytest.mark.parametrize("hw,card,jax_rule", [
    ((32, 64), "float32", "float32"),        # 0.1 MB, under the card's 6 MB
    ((256, 512), "bfloat16", "float32"),     # 6.3 MB
    ((512, 1024), "bfloat16", "float32"),    # 25 MB: library and CLI
    ((1024, 2048), "bfloat16", "bfloat16"),  # 101 MB: OmniScenes
    ((2048, 4096), "bfloat16", "bfloat16"),  # 403 MB: stretch
])
def test_descent_table_on_the_card(hw, card, jax_rule):
    from piccolo_tpu.ops import sampling as jsamp
    from piccolo_tpu_torch.ops import sampling as tsamp

    torch.set_num_threads(1)
    assert tsamp.resolve_descent_table("auto", *hw, CARD) == card
    assert tsamp.resolve_descent_table("auto", *hw) == jax_rule
    assert tsamp.resolve_descent_table("auto", *hw, "cpu") == jax_rule
    assert jsamp.resolve_descent_table("auto", *hw) == jax_rule
    assert tsamp.resolve_descent_table("float32", *hw, CARD) == "float32"


def test_default_plan_bytes_cap_on_the_card(monkeypatch):
    torch.set_num_threads(1)
    seen = []

    def mem_get_info(device=None):
        seen.append(device)
        return 0, H100_BYTES

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    want = int(H100_BYTES * 9 / 16)
    assert sm.default_plan_bytes_cap(CARD) == want
    assert sm.default_plan_bytes_cap("cuda:1") == want
    assert seen == [CARD, torch.device("cuda:1")]
    assert sm.default_plan_bytes_cap("cpu") == sm.DEFAULT_PLAN_BYTES_CAP


@pytest.mark.parametrize("sharpen", [False, True])
def test_admission_picks_the_f32_plan_for_a_card_room(scene, monkeypatch,
                                                      sharpen):
    """A room on the card admits the f32 plan, whole, under sharpen_color
    too (the re-bake is fused and the card's rates decide); the same room
    on the CPU with the CPU rule lifted takes the JAX package's decision,
    which refuses the re-bake."""
    torch.set_num_threads(1)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, H100_BYTES))
    cache, grids = _room(scene)
    cache["device"] = CARD
    got = hl._slab_admission_uncached(
        _cfg(sharpen_color=sharpen, slab_init="auto"), cache, grids,
        scene["img"])
    cap = int(H100_BYTES * 9 / 16)
    m = 2.0 if sharpen else 1.0
    assert got == dict(mode="auto", n_t=N_T, n_t_build=N_T, compact=False,
                       quant=False,
                       cap=dict(f32=int(cap / m),
                                compact=int(cap / (1.25 if sharpen else 1)),
                                q8=int(cap / (1.5 if sharpen else 1))),
                       sharpen=sharpen, wrap=False)
    cpu_cache, _ = _room(scene)
    monkeypatch.setattr(hl, "_auto_plans_off", lambda device: False)
    on_cpu = hl._slab_admission_uncached(
        _cfg(sharpen_color=sharpen, slab_init="auto"), cpu_cache, grids,
        scene["img"])
    assert (on_cpu is None) == sharpen


def test_gather_chunk_rule():
    from piccolo_tpu_torch.init.refine import gather_chunk

    torch.set_num_threads(1)
    assert [gather_chunk(n, CARD) for n in
            (4096, 49152, 65536, 98304, 131072, 196608, 1048576)] == \
        [64, 64, 64, 32, 32, 16, 16]
    assert gather_chunk(4096, "cpu") == 16
    assert gather_chunk(65536, torch.device("cpu")) == 16


@pytest.mark.parametrize("n_pairs", [200, 512])
def test_gather_scores_equal_at_every_chunk(scene, n_pairs):
    """The gather engine's scores are the same bits at chunk 16 (the JAX
    package's) and at the card's default for this cloud (64), on the CPU:
    each pair's loss is summed within its own chunk."""
    from piccolo_tpu_torch.init.refine import _score_pairs, gather_chunk

    torch.set_num_threads(1)
    cache, grids = _room(scene)
    pair_t, pair_r = sm.make_pairs(grids.trans, grids.rot)
    pair_t, pair_r = pair_t[:n_pairs], pair_r[:n_pairs]
    img = torch.tensor(scene["img"])
    chunk = gather_chunk(int(cache["xyz"].shape[0]), CARD)
    assert chunk == 64
    ref = _score_pairs(img, cache["xyz"], cache["rgb"], pair_t, pair_r,
                       cache["mask"], 16)
    for c in (chunk, 32, n_pairs):
        got = _score_pairs(img, cache["xyz"], cache["rgb"], pair_t, pair_r,
                           cache["mask"], c)
        assert torch.equal(got, ref), c
