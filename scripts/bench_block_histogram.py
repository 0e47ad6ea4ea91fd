#!/usr/bin/env python3
"""Time the block-histogram kernel's design choices on one NVIDIA GPU.

    python3 scripts/bench_block_histogram.py [--old OLD.cu] [--out FILE.json]

Builds ``piccolo_tpu_torch/kernels/csrc/block_histogram.cu`` (with ptxas'
report) and variants of it made by edits of its code (never of its
comments), one nvcc each, all started together:
  * ``no_prefetch``: each turn loads its own vectors after the counters
    are zeroed, where the kernel loads the first before zeroing them and
    each next turn's during this turn's adds;
  * ``ldcs``: streaming loads (evict first) where the kernel uses ``__ldg``;
  * ``runs``: one shared atomicAdd a run of equal bins among a warp's 128
    consecutive entries (shuffles and a ballot), not one an entry;
  * ``match_any``: warp-aggregated adds, ``__match_any_sync`` on the bin
    and one add of ``__popc(peers)`` by the lowest lane;
  * ``warp_private``: each warp adds into its own counters, summed at the
    end;
  * ``scalar_loads``: four 4 B loads of ids and of mask a lane where the
    kernel makes one 16 B load;
  * ``unroll_2``, ``unroll_4``: vectors of each input in flight a lane,
    where the kernel has one;
  * ``no_adds``, ``no_loads``, ``no_adds_no_loads``: the vector loop's
    adds, its loads (ids made from the index), or both taken out (wrong
    counts by design, timed all the same): where a launch's time goes;
and ``--old``, an earlier ``block_histogram.cu`` with the launcher
``block_histogram_launch(ids, mask, out, rows, n, num_bins, stream)``
(e.g. unpacked with ``git show <rev>:...`` into the git-ignored
``_archive/``).  Each is launched with CTAs of 256 and of 512 threads (the
old one with its own), checked bit-exact against ``block_histogram_plain``
and timed by chip_smoke's ``cuda_ms`` (device ms, median) on the main
path's calls, each recorded where stage 2 or the colour match makes it
(coherent ids), and on uniform ids at the same shapes:
  * ``library``: the library query's own stage-2 call (chip_smoke's phase 3
    room and query);
  * ``shard``: its first 128 rows, the shape of a 2 x 2 mesh shard's call;
  * ``tracked``: a tracked OmniScenes frame's (3 x 1024, 2048) image rows at
    256 bins, as ``color.color_match_device`` builds them;
  * ``omniscenes``: ``refine.hist_scores_core`` on 50 poses in the
    OmniScenes room at 2048x1024 in 4 x 4 blocks, (800, 131072).
Beside each: the threads ``cta_threads`` chooses, an empty kernel launched
with each CTA size (the floor of one launch), the plain version,
``torch.bincount`` and the bound (chip_smoke's ``_bound``).  Needs CUDA;
writes the numbers as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from piccolo_tpu_torch.kernels import _build  # noqa: E402
from piccolo_tpu_torch.kernels import block_histogram as bh  # noqa: E402

SRC = os.path.join(ROOT, "piccolo_tpu_torch", "kernels", "csrc",
                   "block_histogram.cu")
DIAGNOSTIC = ("no_adds", "no_loads", "no_adds_no_loads")
THREADS = (256, 512)  # CTA sizes each kernel is launched with

_VEC_ADDS = """#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if (v[k] >= 0) atomicAdd(&hist[v[k]], 1);
            }"""
_LOOP = "for (int v0 = first; v0 < nvec; v0 += threads * kUnroll) {"
# the loop with a warp-uniform trip count, for variants whose adds are
# warp-collective
_WARP_LOOP = [(_LOOP, "for (int v0 = first; v0 - (threadIdx.x & 31) < nvec; "
               "v0 += threads * kUnroll) {")]
_RUNS = r"""
// One atomicAdd for each run of equal bins in a warp's 128 consecutive
// entries, four a lane in lane order, by the lane holding its first entry.
__device__ __forceinline__ void add_runs(int* hist, int4 v) {
    const int lane = threadIdx.x & 31;
    int prev = __shfl_up_sync(0xffffffffu, v.w, 1);
    if (lane == 0) prev = -2;
    const bool h0 = v.x != prev, h1 = v.y != v.x, h2 = v.z != v.y,
               h3 = v.w != v.z;
    const int first = h0 ? 0 : h1 ? 1 : h2 ? 2 : h3 ? 3 : 4;
    const unsigned later = __ballot_sync(0xffffffffu, first < 4) &
                           (lane == 31 ? 0u : 0xffffffffu << (lane + 1));
    const int next = later ? __ffs(later) - 1 : 0;
    const int next_first = __shfl_sync(0xffffffffu, first, next);
    const int p = 4 * lane;
    const int e3 = later ? 4 * next + next_first : 128;
    const int e2 = h3 ? p + 3 : e3;
    const int e1 = h2 ? p + 2 : e2;
    const int e0 = h1 ? p + 1 : e1;
    if (h0 && v.x >= 0) atomicAdd(&hist[v.x], e0 - p);
    if (h1 && v.y >= 0) atomicAdd(&hist[v.y], e1 - p - 1);
    if (h2 && v.z >= 0) atomicAdd(&hist[v.z], e2 - p - 2);
    if (h3 && v.w >= 0) atomicAdd(&hist[v.w], e3 - p - 3);
}

"""
_MATCH = r"""
// match_any on the bin, one atomicAdd of the peers' count by the lowest.
__device__ __forceinline__ void add_runs(int* hist, int4 v) {
    const int lane = threadIdx.x & 31;
    const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned peers = __match_any_sync(0xffffffffu, e[k]);
        if (e[k] >= 0 && lane == __ffs(peers) - 1) {
            atomicAdd(&hist[e[k]], __popc(peers));
        }
    }
}

"""
_KERNEL_AT = "__global__ void __launch_bounds__(kMaxThreads)\nblock_histogram_kernel("
_CALL = "add_runs(hist, make_int4(v[0], v[1], v[2], v[3]));"
_PRIVATE = [
    ("const size_t smem = static_cast<size_t>(num_bins) * sizeof(int);",
     "const size_t smem = static_cast<size_t>(num_bins) * sizeof(int) * "
     "(threads / 32);\n    cudaFuncSetAttribute(reinterpret_cast<const void*>("
     "kernel), cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);"),
    ("for (int j = threadIdx.x; j < num_bins; j += threads) hist[j] = 0;",
     "for (int j = threadIdx.x; j < num_bins * (threads / 32); j += threads)"
     " hist[j] = 0;\n    int* whist = hist + (threadIdx.x >> 5) * num_bins;"),
    ("if (v[k] >= 0) atomicAdd(&hist[v[k]], 1);",
     "if (v[k] >= 0) atomicAdd(&whist[v[k]], 1);"),
    ("if (v >= 0) atomicAdd(&hist[v], 1);",
     "if (v >= 0) atomicAdd(&whist[v], 1);"),
    ("    float* orow = out + static_cast<size_t>(row) * num_bins;\n",
     "    for (int j = threadIdx.x; j < num_bins; j += threads) {\n"
     "        int s = 0;\n"
     "        for (int w = 0; w < threads / 32; ++w) s += hist[w * num_bins + j];\n"
     "        hist[j] = s;\n"
     "    }\n"
     "    float* orow = out + static_cast<size_t>(row) * num_bins;\n"),
]
# each turn loads its own vectors, after the counters are zeroed
_NO_PREFETCH = [
    ("load(first);", ""),
    ("load(v0 + threads * kUnroll);", ""),
    ("int4 a[kUnroll];", "load(v0);\n        int4 a[kUnroll];"),
]
# parts taken out, to see where a launch's time goes: the adds (the loads
# stay live), the loads (ids made from the index, so the adds stay), both
_NO_ADDS = [("if (v[k] >= 0) atomicAdd(&hist[v[k]], 1);",
             "if (v[k] == 0x7fffffff) atomicAdd(&hist[0], 1);")]
_NO_LOADS = [("""                next_ids[u] = __ldg(ids4 + i);
                next_mask[u] = __ldg(mask4 + i);""",
              """                next_ids[u] = make_int4(i & 511, (i + 1) & 511,
                                        (i + 2) & 511, (i + 3) & 511);
                next_mask[u] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);""")]
# name -> edits of the current source's code, in order
VARIANTS = {
    "no_adds": _NO_ADDS,
    "no_loads": _NO_LOADS,
    "no_adds_no_loads": _NO_ADDS + _NO_LOADS,
    "no_prefetch": _NO_PREFETCH,
    "ldcs": [("next_ids[u] = __ldg(ids4 + i);",
              "next_ids[u] = __ldcs(ids4 + i);"),
             ("next_mask[u] = __ldg(mask4 + i);",
              "next_mask[u] = __ldcs(mask4 + i);")],
    "runs": _WARP_LOOP + [(_KERNEL_AT, _RUNS + _KERNEL_AT),
                          (_VEC_ADDS, _CALL)],
    "match_any": _WARP_LOOP + [(_KERNEL_AT, _MATCH + _KERNEL_AT),
                               (_VEC_ADDS, _CALL)],
    "warp_private": _PRIVATE,
    "scalar_loads": [(
        "                next_ids[u] = __ldg(ids4 + i);\n"
        "                next_mask[u] = __ldg(mask4 + i);\n",
        "                const int* s = rid + head + 4 * i;\n"
        "                const float* t = rmask + head + 4 * i;\n"
        "                next_ids[u] = make_int4(__ldg(s), __ldg(s + 1), "
        "__ldg(s + 2), __ldg(s + 3));\n"
        "                next_mask[u] = make_float4(__ldg(t), __ldg(t + 1), "
        "__ldg(t + 2), __ldg(t + 3));\n")],
    "unroll_2": [("constexpr int kUnroll = 1;", "constexpr int kUnroll = 2;")],
    "unroll_4": [("constexpr int kUnroll = 1;", "constexpr int kUnroll = 4;")],
}


def variant_source(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"a variant's target text is not in the source "
                               f"once: {old!r}")
        text = text.replace(old, new)
    return text


def _start_nvcc(src, out, verbose=False):
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose
                                                   else []) + ["-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_libraries(old_src, tmp, names=None):
    """The current source (with ptxas' report), its variants (``names``, or
    all) and the old source, one nvcc each, all started together."""
    text = open(SRC).read()
    jobs = {"current": _start_nvcc(SRC, os.path.join(tmp, "current.so"),
                                   verbose=True)}
    for name, edits in VARIANTS.items():
        if names and name not in names:
            continue
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(text, edits))
        jobs[name] = _start_nvcc(path, os.path.join(tmp, f"{name}.so"))
    if old_src:
        jobs["old"] = _start_nvcc(old_src, os.path.join(tmp, "old.so"))
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        if name == "current":
            cs.log("ptxas (current source):\n" + "\n".join(
                ln for ln in out.splitlines() if "Used" in ln or "spill" in ln
                or "Compiling" in ln))
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        fn = lib.block_histogram_launch
        n_int = 3 if name == "old" else 4
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if name == "current":
            fe = lib.block_histogram_empty_launch
            fe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fe.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, old, ids, mask, out, nbins, T):
    B, N = ids.shape

    def run():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = (ids.data_ptr(), mask.data_ptr(), out.data_ptr(), B, N, nbins)
        err = (lib.block_histogram_launch(*args, stream) if old else
               lib.block_histogram_launch(*args, T, stream))
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def data_sets(dev, tmp):
    """name -> (ids, mask, num_bins), coherent (the main path's own calls)
    and uniform at the same shapes."""
    from piccolo_tpu_torch.config import parse_ini
    from piccolo_tpu_torch.data import omniscenes_pano_glob, read_omniscenes
    from piccolo_tpu_torch.harness.imaging import imread_rgb
    from piccolo_tpu_torch.harness.localize import resize_ablate_omniscenes
    from piccolo_tpu_torch.init.refine import hist_scores_core
    from piccolo_tpu_torch.testing import random_pose_inside, write_synth_omniscenes

    def only_call(calls):
        (_, _, nbins), (ids, mask) = next(iter(calls.items()))
        return ids, mask, nbins

    sets = {}
    room = cs.phase_room(dev)
    calls = {}
    _, _, img_init, img_main = cs._query_images(100, room["xyz"], room["rgb"],
                                                dev)
    with cs._recording_stage2(calls):
        cs._query(room, img_init, img_main, dev)
    ids, mask, nbins = sets["library"] = only_call(calls)
    # a 2 x 2 mesh shard's call
    sets["shard"] = (ids[:128].contiguous(), mask[:128].contiguous(), nbins)
    del room

    tree = os.path.join(tmp, "omni")
    write_synth_omniscenes(tree, rooms=1, queries=1, points=60000,
                           height=1024, seed=7, oracle="raycast")
    cfg = parse_ini(cs.OMNI_CONFIG)
    frame = sorted(glob.glob(omniscenes_pano_glob(tree)))[0]
    img = torch.as_tensor(
        resize_ablate_omniscenes(cfg, imread_rgb(frame)).astype(np.float32)
        / 255.0, device=dev)
    H, W, _ = img.shape
    img_i = (img * 255).to(torch.int32)
    nonblack = img_i.sum(-1) > 0
    sets["tracked"] = (img_i.permute(2, 0, 1).reshape(3 * H, W).contiguous(),
                       nonblack.to(torch.float32).repeat(3, 1).contiguous(),
                       256)
    pcd = glob.glob(os.path.join(tree, "omniscenes", "pcd", "*.txt"))[0]
    xyz, rgb = read_omniscenes(pcd)
    rng = np.random.default_rng(5)
    poses = [random_pose_inside(rng, cs.SIZE)
             for _ in range(int(cfg.num_intermediate))]
    calls = {}
    with cs._recording_stage2(calls):
        hist_scores_core(
            img, torch.as_tensor(xyz, dtype=torch.float32, device=dev),
            torch.as_tensor(rgb, dtype=torch.float32, device=dev),
            torch.as_tensor(np.stack([p[0] for p in poses]), device=dev),
            torch.as_tensor(np.stack([p[1] for p in poses]), device=dev),
            None, int(cfg.num_split_h), int(cfg.num_split_w), 4)
    sets["omniscenes"] = only_call(calls)
    del calls
    g = torch.Generator(device="cpu").manual_seed(0)
    for name in ("library", "shard", "tracked", "omniscenes"):
        ids, mask, nbins = sets[name]
        u_ids = torch.randint(-3, nbins + 18, tuple(ids.shape), generator=g,
                              dtype=torch.int32).to(dev)
        u_mask = (torch.rand(tuple(ids.shape), generator=g) < 0.8).to(
            torch.float32).to(dev)
        sets[f"{name}.uniform"] = (u_ids, u_mask, nbins)
    return sets


def bench(libs, dev, sets, out):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fe = libs["current"].block_histogram_empty_launch
    for name, (ids, mask, nbins) in sets.items():
        B, N = ids.shape
        want = bh.block_histogram_plain(ids, mask, nbins)
        chosen = bh.cta_threads(B, sms)
        res = dict(shape=[B, N], num_bins=nbins, threads=chosen,
                   **cs._run_stats(ids, mask, nbins))
        res["bound_ms"], res["bound_by"] = cs._bound(
            ids.numel() * 8 + B * nbins * 4, ids.numel() * 2)
        res["plain_ms"] = cs.cuda_ms(
            lambda: bh.block_histogram_plain(ids, mask, nbins), reps=5)
        flat = (torch.arange(B, device=dev)[:, None] * nbins
                + ids.clamp(0, nbins - 1)).reshape(-1)
        w = ((mask != 0) & (ids >= 0) & (ids < nbins)).to(torch.float32)
        res["library_ms"] = cs.cuda_ms(lambda: torch.bincount(
            flat, weights=w.reshape(-1), minlength=B * nbins), reps=5)
        del flat, w
        res["empty_ms"] = {}
        for T in THREADS:
            def empty(T=T):
                stream = ctypes.c_void_p(
                    torch.cuda.current_stream().cuda_stream)
                if fe(B, N, nbins, T, stream):
                    raise RuntimeError("empty launch failed")
            res["empty_ms"][f"T{T}"] = cs.cuda_ms(empty)
        res["ms"], res["wrong"] = {}, []
        got = torch.empty_like(want)
        for lib_name, lib in libs.items():
            for T in ((0,) if lib_name == "old" else THREADS):
                run = launcher(lib, lib_name == "old", ids, mask, got, nbins,
                               T)
                got.fill_(-1.0)
                run()
                torch.cuda.synchronize()
                key = lib_name if lib_name == "old" else f"{lib_name}/T{T}"
                if not torch.equal(got, want):
                    res["wrong"].append(key)
                    if lib_name not in DIAGNOSTIC:
                        continue
                res["ms"][key] = cs.cuda_ms(run)
        res["chosen_ms"] = res["ms"].get(f"current/T{chosen}")
        best = sorted(res["ms"].items(), key=lambda kv: kv[1])
        per_variant = {}
        for k, v in best:
            per_variant.setdefault(k.split("/")[0], (k, v))
        cs.log(f"{name} {B}x{N} ({nbins} bins; {chosen} threads "
               f"{res['chosen_ms']}; counted {res['counted_share']:.3f}, "
               f"{res['counted_per_run']:.2f} a run): bound "
               f"{res['bound_ms']:.4f}, plain {res['plain_ms']:.4f}, bincount "
               f"{res['library_ms']:.4f}; wrong {res['wrong']}")
        cs.log("  empty: " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in res["empty_ms"].items()))
        cs.log("  best of each: " + ", ".join(
            f"{k} {v:.4f}" for k, v in per_variant.values()))
        cs.log("  current: " + ", ".join(
            f"{k.split('/', 1)[1]} {v:.4f}" for k, v in res["ms"].items()
            if k.startswith("current/")))
        out[name] = res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="an earlier block_histogram.cu to time "
                    "against")
    ap.add_argument("--variants", help="comma-separated variants to build "
                    "(default: all)")
    ap.add_argument("--sets", help="comma-separated data sets to time "
                    "(default: all)")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "bench_block_histogram.json"))
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    tmp = tempfile.mkdtemp(prefix="bh_bench_")
    out = dict(device=smi)
    try:
        t0 = time.time()
        libs = build_libraries(args.old, tmp, args.variants and
                               args.variants.split(","))
        cs.log(f"built {sorted(libs)} in {time.time() - t0:.2f} s")
        sets = data_sets(dev, tmp)
        if args.sets:
            sets = {k: sets[k] for k in args.sets.split(",")}
        bench(libs, dev, sets, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        cs.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
